"""The association scan over fresh generated rows: the port's scan step
with the host feed out of the way.

A job is what `associate` runs per batch and at the end, over the
configuration's whole table (ceil(kmers / scan_batch_rows) batches): a
fresh `ops.scanstep.init_buffered_state`, one `scan_step_compact` per batch
with associate's keywords (pipeline.scan's CAND_W, CAND_Q, BUF_CAP and its
cand_k rule), then `flush_buffered` and the top-k taken to the host. Batch
b of job i is the benchmark generator's batch i * batches + b (planes and
fused popcounts), its rows numbered b * rows + r.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from benchmark import compare, gen, inputs
from benchmark.drivers import sync
from benchmark.reference import scan as ref
from benchmark.trace import span


class Cell:
    def __init__(self, ctx):
        from kmersgwas_tpu_torch.ops import scanstep, score
        from kmersgwas_tpu_torch.pipeline import scan
        self.ss, self.score_ops, self.scan_mod = scanstep, score, scan
        cfg = ctx.cfg
        self.ctx = ctx
        self.rate_metric = ctx.mix["rate_metric"]
        self.dev = ctx.device
        self.n, self.p, self.k = (cfg["n_accessions"], cfg["phenotypes"],
                                  cfg["top_k"])
        self.rows = cfg["scan_batch_rows"]
        self.batches = math.ceil(cfg["kmers"] / self.rows)
        self.w32 = inputs.lanes_w32(self.n)
        if self.rows % scan.TILE_ROWS or self.batches * self.rows > 1 << 31:
            raise ValueError("batch rows must be whole tiles and a job's row "
                             "ids below 2^31")
        self.mc = scan.effective_min_count(self.n, cfg["maf"], cfg["mac"])
        self.kw = dict(n_used=self.n, min_count=self.mc,
                       cand_k=min(max(256, self.k // 8), self.k, self.rows),
                       tile_rows=scan.TILE_ROWS, cand_w=scan.CAND_W,
                       cand_q=scan.CAND_Q, precision=cfg["score_precision"])
        self.key = inputs.subseed(ctx.seed, "planes")
        self.results = []          # (job, (P, K) scores, (P, K) row ids)
        ctx.record["work"] = {"rows_per_job": self.batches * self.rows,
                              "n_used": self.n, "p": self.p,
                              "w32": self.w32}

    def setup(self, warm: bool = True) -> None:
        self.y = inputs.phenotypes(self.n, self.p, self.ctx.seed, self.dev)
        self.yp, self.ysum = self.score_ops.prepare_phenotypes(
            self.y, 32 * self.w32, self.dev)
        self.iota = torch.arange(self.rows, dtype=torch.int32,
                                 device=self.dev)
        self.hi0 = torch.zeros(self.rows, dtype=torch.int32, device=self.dev)
        if warm:    # the ramp's fallbacks, then wide and narrow appends
            self._job(0, self.ctx.mix["warm_batches"],
                      inputs.subseed(self.ctx.seed, "warm"), keep=False)
        sync(self.dev)

    def _job(self, i: int, n_batches: int, key: int, keep: bool) -> int:
        st = self.ss.init_buffered_state(self.p, self.k, self.scan_mod.BUF_CAP,
                                         self.dev)
        counts = {}
        for b in range(n_batches):
            planes, pc = gen.gen_planes(self.rows, self.w32, key,
                                        i * self.batches + b, self.dev)
            t0 = time.perf_counter()
            with span("step"):
                self.ss.scan_step_compact(
                    st, planes, pc, self.iota + b * self.rows, self.hi0,
                    self.yp, self.ysum, counts=counts, **self.kw)
            if keep:
                self.ctx.span("scan_step", time.perf_counter() - t0)
        with span("flush"):
            plain = self.ss.flush_buffered(st)
            scores = plain.scores.cpu().numpy()
            ids = (plain.row_hi.to(torch.int64) * (1 << 30)
                   + plain.row_lo.to(torch.int64)).cpu().numpy()
        if keep:
            for key_, v in counts.items():
                self.ctx.count(key_, v)
            self.results.append((i, scores, ids))
        return n_batches * self.rows

    def job(self, i: int) -> int:
        return self._job(i, self.batches, self.key, keep=True)

    def traced_job(self, i: int) -> int:
        return self._job(i, self.batches, self.key, keep=False)

    def record(self) -> dict:
        return self.ctx.record

    def free(self) -> None:
        del self.yp, self.ysum
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def _y64(self) -> torch.Tensor:
        y = torch.zeros((32 * self.w32, self.p), dtype=torch.float64,
                        device=self.dev)
        y[:self.n] = torch.from_numpy(self.y).to(self.dev, torch.float64)
        return y

    def _rescore(self, i: int, ids: np.ndarray, y64) -> np.ndarray:
        """float64 scores (P, K) of job i's rows `ids` (P, K), each row
        regenerated from its id by the generator's plain twin."""
        uniq, inv = np.unique(ids, return_inverse=True)
        u = torch.from_numpy(uniq).to(self.dev)
        planes, pc = gen.gen_planes_plain(
            u % self.rows, self.w32, self.key, i * self.batches + u // self.rows)
        s = ref.scores64(planes, pc.double(), y64, self.n, self.mc)
        inv = torch.from_numpy(inv.reshape(ids.shape)).to(self.dev)
        cols = torch.arange(self.p, device=self.dev)[:, None]
        return s[inv, cols].cpu().numpy()

    def check(self, rng) -> dict:
        y64 = self._y64()
        j = int(rng.integers(len(self.results)))
        i, scores, ids = self.results[j]
        s64 = self._rescore(i, ids, y64)
        gap, scale = compare.score_gap(scores, s64, ids)
        # completeness: every row of a sample of job i's batches, re-scored
        floor = torch.from_numpy(s64.min(axis=1)).to(self.dev)
        rep = torch.from_numpy(ids).to(self.dev)
        best = torch.full((self.p,), float("-inf"), dtype=torch.float64,
                          device=self.dev)
        sample = rng.choice(self.batches, replace=False, size=min(
            self.ctx.mix["check_batches"], self.batches))
        for b in sample.tolist():
            planes, pc = gen.gen_planes(self.rows, self.w32, self.key,
                                        i * self.batches + b, self.dev)
            s = ref.scores64(planes, pc.double(), y64, self.n, self.mc)
            row_ids = torch.arange(self.rows, device=self.dev) + b * self.rows
            best = torch.maximum(best, compare.best_left_out(
                s, row_ids, rep, floor))
        missed = compare.missed_gap(best.cpu().numpy(), s64, scale)
        # every other job: its columns' first entries and a sample of the
        # rest, and no row twice in a column
        m = self.ctx.mix["check_entries"]
        for jj, (i2, sc2, ids2) in enumerate(self.results):
            if jj == j:
                continue
            pick = np.concatenate([[0], rng.choice(
                np.arange(1, self.k), size=m, replace=False)])
            s2 = self._rescore(i2, ids2[:, pick], y64)
            gap = max(gap, compare.score_gap(sc2[:, pick], s2,
                                             ids2[:, pick])[0])
            if compare.repeats(ids2):
                gap = float("inf")
        return {"score_gap": gap, "missed_gap": missed}

    def control(self, rng) -> dict:
        """Job 0's rows through the reference at float8 phenotypes in the
        program's place, then the same check."""
        y32 = self._y64().to(torch.float32)
        top = ref.RunningTopK(self.p, self.k, self.dev)
        for b in range(self.batches):
            planes, pc = gen.gen_planes(self.rows, self.w32, self.key, b,
                                        self.dev)
            s = ref.scores_lowp(planes, pc, y32, self.n, self.mc)
            top.add(s, torch.arange(self.rows, device=self.dev)
                    + b * self.rows)
        self.results = [(0, top.v.cpu().numpy(), top.ids.cpu().numpy())]
        return self.check(rng)
