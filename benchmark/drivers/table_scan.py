"""The association scan as a user runs it: `pipeline.scan.associate` over a
k-mers `.table` with its `.dtable` cache.

Set-up writes the table (the configuration's table_rows, from the seed,
with the benchmark's own writer of the format) and makes the first
`associate` call, which builds the dtable, as a user's first run does. A
job is one `associate` call over the whole table (certify_topk off, its
default); jobs repeat with the table in the page cache. A job's rows are
the table's, counted from the benchmark's own inputs and not from what the
program reports (its `n_tested`): the check holds each answer to every row.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import compare, inputs
from benchmark.drivers import sync
from benchmark.reference import scan as ref
from benchmark.reference.tablefile import read_table
from benchmark.trace import patched_spans

BLOCK = 1 << 20


def _words(rows, device) -> torch.Tensor:
    """A block of table rows -> its presence words as (R, 2 W) int32."""
    return torch.from_numpy(np.ascontiguousarray(rows[:, 1:]).view(
        np.int32)).to(device)


class Cell:
    def __init__(self, ctx):
        from kmersgwas_tpu_torch.ops import scanstep
        from kmersgwas_tpu_torch.parallel import sharding
        from kmersgwas_tpu_torch.pipeline import feed, scan
        self.scan_mod = scan
        self.span_targets = [
            (feed, "device_batches", "feed.wait", True),
            (scanstep, "compact_candidates", "step.candidates", False),
            (scanstep, "compact_apply", "step.apply", False),
            (sharding, "finalize_sharded_buffered", "finalize", False),
            (scan, "fetch_rows", "fetch", False),
            (scan, "select_candidates", "select", False)]
        cfg = ctx.cfg
        self.ctx = ctx
        self.rate_metric = ctx.mix["rate_metric"]
        self.dev = ctx.device
        self.n, self.p, self.k = (cfg["n_accessions"], cfg["phenotypes"],
                                  cfg["top_k"])
        self.rows = cfg["scan_batch_rows"]
        self.table_rows = cfg["table_rows"]
        self.base = os.path.join(ctx.workdir, "t")
        self.dtable = self.base + ".dtable"
        self.results = []           # ScanResult of each job
        ctx.record["work"] = {"rows_per_job": self.table_rows,
                              "n_used": self.n, "p": self.p}

    def setup(self, warm: bool = True) -> None:
        inputs.fresh_dir(self.ctx.workdir)
        inputs.write_table(self.base, self.n, self.table_rows,
                           self.ctx.cfg["kmer_len"], self.ctx.seed, self.dev)
        self.y = inputs.phenotypes(self.n, self.p, self.ctx.seed, self.dev)
        self.names = [f"acc{i}" for i in range(self.n)]
        if warm:        # builds the dtable
            self._associate()
        os.sync()       # the written files reach the disk before the window
        sync(self.dev)

    def _associate(self):
        cfg = self.ctx.cfg
        return self.scan_mod.associate(
            self.base, self.names, self.y, [f"y{j}" for j in range(self.p)],
            kmer_len=cfg["kmer_len"], device=self.dev, n_top=self.k,
            maf=cfg["maf"], mac=cfg["mac"], batch_size=self.rows,
            dtable_cache=self.dtable, progress=lambda r: None)

    def job(self, i: int) -> int:
        res = self._associate()
        for key in ("narrow", "wide", "fallback", "flush"):
            self.ctx.count(key, res.steps.get(key, 0))
        for t in res.steps.get("step_s", []):
            self.ctx.span("scan_step", t)
        for key in ("finalize", "fetch"):
            self.ctx.span("associate." + key, res.timings[key])
        self.results.append(res)
        return self.table_rows

    def traced_job(self, i: int) -> int:
        with patched_spans(self.span_targets):
            self._associate()
        return self.table_rows

    def record(self) -> dict:
        return self.ctx.record

    def free(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def _reference(self):
        """float64 scores (R, P) of every table row on the device, the
        codes (R,) and the presence words (R, W) on the host."""
        _, _, rows = read_table(self.base)
        y64 = torch.zeros((64 * (rows.shape[1] - 1), self.p),
                          dtype=torch.float64, device=self.dev)
        y64[:self.n] = torch.from_numpy(self.y).to(self.dev, torch.float64)
        mc = ref.min_count(self.n, self.ctx.cfg["maf"], self.ctx.cfg["mac"])
        s = []
        for b in range(0, rows.shape[0], BLOCK):
            w = _words(rows[b:b + BLOCK], self.dev)
            s.append(ref.scores64(w, ref.n1_of(w, self.n), y64, self.n, mc))
        return torch.cat(s), np.asarray(rows[:, 0]), rows

    def _judge(self, s64, codes, table, scores, rows, kmers, pa) -> dict:
        """The numbers for one job's (P, K) reported scores, table rows,
        k-mer codes and (P, K, W) presence words."""
        ok_shape = rows.shape == (self.p, self.k)
        if not ok_shape:
            return {"score_gap": float("inf"), "missed_gap": float("inf")}
        flat = rows.reshape(-1)
        valid = ((kmers.reshape(-1) == codes[flat])
                 & (pa.reshape(flat.shape[0], -1)
                    == np.asarray(table[flat])[:, 1:]).all(axis=1))
        rows_t = torch.from_numpy(rows).to(self.dev)
        cols = torch.arange(self.p, device=self.dev)[:, None]
        exact = s64[rows_t, cols].cpu().numpy()
        gap, scale = compare.score_gap(scores, exact, rows,
                                       valid.reshape(rows.shape))
        best = compare.best_left_out(
            s64, torch.arange(s64.shape[0], device=self.dev), rows_t,
            torch.from_numpy(exact.min(axis=1)).to(self.dev))
        return {"score_gap": gap,
                "missed_gap": compare.missed_gap(best.cpu().numpy(), exact,
                                                 scale)}

    def check(self, rng) -> dict:
        """Every job's answer, each distinct answer judged once (the jobs
        scan the same table, so a sound program gives one answer)."""
        s64, codes, table = self._reference()
        out = {"score_gap": 0.0, "missed_gap": 0.0}
        judged = []
        for res in self.results:
            raw = [np.asarray(a) for a in (*res.rows, *res.scores,
                                           *res.kmers, res.pa_rows.rows,
                                           res.pa_rows.values)]
            if any(len(raw) == len(j) and all(
                    np.array_equal(a, b) for a, b in zip(raw, j))
                    for j in judged):
                continue
            judged.append(raw)
            try:
                rows = np.stack([np.asarray(r, np.int64) for r in res.rows])
                scores = np.stack([np.asarray(v, np.float64)
                                   for v in res.scores])
                kmers = np.stack([np.asarray(c, np.uint64)
                                  for c in res.kmers])
                pa = np.asarray(res.pa_rows.take(rows.reshape(-1)))
            except (ValueError, KeyError):      # ragged or unfetched
                return {"score_gap": float("inf"),
                        "missed_gap": float("inf")}
            got = self._judge(s64, codes, table, scores, rows, kmers, pa)
            out = {k: max(out[k], v) for k, v in got.items()}
        return out

    def control(self, rng) -> dict:
        """The table's rows through the reference at float8 phenotypes in
        the program's place (its codes and presence words read from the
        table), then the same check."""
        _, _, table = read_table(self.base)
        y32 = torch.zeros((64 * (table.shape[1] - 1), self.p),
                          dtype=torch.float32, device=self.dev)
        y32[:self.n] = torch.from_numpy(self.y).to(self.dev)
        mc = ref.min_count(self.n, self.ctx.cfg["maf"], self.ctx.cfg["mac"])
        top = ref.RunningTopK(self.p, self.k, self.dev)
        for b in range(0, table.shape[0], BLOCK):
            w = _words(table[b:b + BLOCK], self.dev)
            n1 = ref.n1_of(w, self.n)
            keep = torch.nonzero((n1 >= mc) & (self.n - n1 >= mc)).flatten()
            s = ref.scores_lowp(w[keep], n1[keep].float(), y32, self.n, mc)
            top.add(s, keep + b)
        rows = top.ids.cpu().numpy()
        s64, codes, _ = self._reference()
        pa = np.asarray(table[rows.reshape(-1)])[:, 1:]
        return self._judge(s64, codes, table, top.v.cpu().numpy(), rows,
                           codes[rows], pa)
