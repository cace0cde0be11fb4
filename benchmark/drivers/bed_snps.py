"""The SNP arm's prefilter as a user runs it: `snps.bed.load_bed_planes`
then `snps.assoc.most_associated_snps` over a PLINK bed, the two calls
that `associate-snps` and `gwas --run_on_snps_two_steps` make.

Set-up writes the bed, bim and fam (the configuration's snps over n_fam
accessions in a shuffled order, from the seed, with the benchmark's own
writer of the format), makes the phenotypes of the used accessions and
runs one warm job. A job is the used accessions' planes on the device,
every phenotype column scored, and each column's top_k SNP indices and
their scores on the host; jobs repeat with the bed in the page cache. The
export of the selected rows is left out (`gwas` does not run it). A job's
rows are the bed's SNPs, counted from the benchmark's own inputs: the
check holds each answer to every SNP.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import compare, inputs
from benchmark.drivers import sync
from benchmark.reference import bedfile
from benchmark.reference import snp as ref

CHUNK = 1 << 16


def write_bed(base: str, n_fam: int, n_used: int, m: int, seed: int,
              device) -> list:
    """A PLINK bed of m SNPs over n_fam accessions acc0 ... in a shuffled
    fam order; returns the n_used accessions used, in the phenotypes' order.

    Each SNP's minor allele is carried, homozygous, by k accessions, k drawn
    with weight 1/k from 1 ... n_fam // 2 (a neutral folded spectrum); the
    minor allele is the bim's second or first at random; then each call is
    missing with probability 2 % and heterozygous with 0.5 %."""
    rng = np.random.default_rng(inputs.subseed(seed, "accessions"))
    names = [f"acc{i}" for i in range(n_fam)]
    fam = [names[i] for i in rng.permutation(n_fam)]
    used = [names[i] for i in rng.choice(n_fam, n_used, replace=False)]
    g = inputs.generator(seed, "genotypes", device)
    weights = 1.0 / torch.arange(1, n_fam // 2 + 1, dtype=torch.float64,
                                 device=device)
    lane = torch.arange(n_fam, device=device)
    with bedfile.BedWriter(base, fam, m) as bw:
        for s in range(0, m, CHUNK):
            c = min(CHUNK, m - s)
            k = 1 + torch.multinomial(weights, c, replacement=True,
                                      generator=g)
            perm = torch.rand((c, n_fam), generator=g,
                              device=device).argsort(dim=1)
            minor = torch.zeros((c, n_fam), dtype=torch.bool, device=device)
            minor.scatter_(1, perm, lane[None, :] < k[:, None])
            alt = torch.rand((c, 1), generator=g, device=device) < 0.5
            d = 3 * (minor == alt).to(torch.uint8)
            u = torch.rand((c, n_fam), generator=g, device=device)
            d[u < 0.025] = 2
            d[u < 0.02] = 1
            bw.append(d)
    return used


class Cell:
    def __init__(self, ctx):
        from kmersgwas_tpu_torch.snps import assoc, bed
        self.assoc, self.bed = assoc, bed
        cfg = ctx.cfg
        self.ctx = ctx
        self.rate_metric = ctx.mix["rate_metric"]
        self.dev = ctx.device
        self.n_fam, self.n, self.p, self.k, self.m = (
            cfg["n_fam"], cfg["n_accessions"], cfg["phenotypes"],
            cfg["top_k"], cfg["snps"])
        self.base = os.path.join(ctx.workdir, "g")
        self.results = []           # (indices, scores) of each job
        ctx.record["work"] = {"rows": self.m, "n_used": self.n,
                              "p": self.p, "w32": inputs.lanes_w32(self.n)}

    def setup(self, warm: bool = True) -> None:
        inputs.fresh_dir(self.ctx.workdir)
        self.used = write_bed(self.base, self.n_fam, self.n, self.m,
                              self.ctx.seed, self.dev)
        self.y = inputs.phenotypes(self.n, self.p, self.ctx.seed, self.dev)
        if warm:
            self._run()
        os.sync()       # the written files reach the disk before the window
        sync(self.dev)

    def _run(self):
        """One job -> ((P, K) int64 SNP indices, each column's ascending,
        (P, K) float32 scores of them), on the host."""
        cfg = self.ctx.cfg
        planes = self.bed.load_bed_planes(self.base, self.used,
                                          device=self.dev)
        idx, scores = self.assoc.most_associated_snps(
            planes, self.y, self.k, cfg["maf"], cfg["mac"])
        idx = np.stack(idx)
        at = torch.from_numpy(idx).to(self.dev)
        cols = torch.arange(self.p, device=self.dev)[:, None]
        return idx, scores[at, cols].cpu().numpy()

    def job(self, i: int) -> int:
        self.results.append(self._run())
        return self.m

    def traced_job(self, i: int) -> int:
        self._run()
        return self.m

    def record(self) -> dict:
        return self.ctx.record

    def free(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def _scores64(self, y: np.ndarray) -> torch.Tensor:
        """(M, P) float64 scores of every SNP of the bed, for phenotypes
        y, by the reference from the bed's bytes."""
        fam, rows = bedfile.read_bed(self.base)
        pos = {nm: i for i, nm in enumerate(fam)}
        cols = torch.tensor([pos[nm] for nm in self.used], device=self.dev)
        y64 = torch.from_numpy(np.asarray(y, np.float64)).to(self.dev)
        mc = ref.min_count(self.n, self.ctx.cfg["maf"], self.ctx.cfg["mac"])
        return ref.scores64(rows, cols, len(fam), y64, mc)

    def _judge(self, s64: torch.Tensor, idx, scores) -> dict:
        """The numbers for one job's (P, K) indices and reported scores."""
        inf = {"score_gap": float("inf"), "missed_gap": float("inf")}
        k = min(self.k, s64.shape[0])
        if idx.shape != (self.p, k) or scores.shape != (self.p, k) or (
                idx.min() < 0 or idx.max() >= s64.shape[0]):
            return inf
        at = torch.from_numpy(np.asarray(idx, np.int64)).to(self.dev)
        cols = torch.arange(self.p, device=self.dev)[:, None]
        exact = s64[at, cols].cpu().numpy()
        gap, scale = compare.score_gap(scores, exact, idx)
        best = compare.best_left_out(
            s64, torch.arange(s64.shape[0], device=self.dev), at,
            torch.from_numpy(exact.min(axis=1)).to(self.dev))
        return {"score_gap": gap,
                "missed_gap": compare.missed_gap(best.cpu().numpy(), exact,
                                                 scale)}

    def check(self, rng) -> dict:
        """Every job's answer, each distinct answer judged once (the jobs
        read the same bed, so a sound program gives one answer)."""
        s64 = self._scores64(self.y)
        out = {"score_gap": 0.0, "missed_gap": 0.0}
        judged = []
        for idx, scores in self.results:
            if any(np.array_equal(idx, a) and np.array_equal(scores, b)
                   for a, b in judged):
                continue
            judged.append((idx, scores))
            got = self._judge(s64, idx, scores)
            out = {key: max(out[key], v) for key, v in got.items()}
        return out

    def control(self, rng) -> dict:
        """The reference in the program's place with the phenotypes rounded
        to TF32 (each column's top_k of its float64 scores, and those
        scores), then the same check."""
        y32 = torch.from_numpy(self.y)
        s = self._scores64(ref.to_tf32_values(y32).numpy())
        at = ref.top_rows(s, min(self.k, s.shape[0]))
        cols = torch.arange(self.p, device=self.dev)[:, None]
        idx, scores = at.cpu().numpy(), s[at, cols].cpu().numpy()
        del s, at
        return self._judge(self._scores64(self.y), idx, scores)
