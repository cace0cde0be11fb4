"""The EMMA kinship as a user runs it: `pipeline.kinship.kinship_from_table`
over a k-mers `.table` with its `.dtable` cache.

Set-up writes the table (the configuration's table_rows, from the seed,
with the benchmark's own writer of the format) and makes the first call,
which builds the dtable. A job is one call over the whole table; jobs
repeat with the table in the page cache. A job's rows are the table's,
counted from the benchmark's own inputs and not from what the program
reports: the check holds each matrix to every row.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import compare, inputs
from benchmark.drivers import sync
from benchmark.drivers.table_scan import BLOCK, _words
from benchmark.reference import kinship as ref
from benchmark.reference import scan as ref_scan
from benchmark.reference.tablefile import read_table
from benchmark.trace import patched_spans


class Cell:
    def __init__(self, ctx):
        from kmersgwas_tpu_torch.ops.kinship import KinshipAccumulator
        from kmersgwas_tpu_torch.pipeline import feed, kinship
        self.kin_mod = kinship
        self.span_targets = [
            (feed, "device_planes", "feed.wait", True),
            (KinshipAccumulator, "add", "add", False),
            (KinshipAccumulator, "finalize", "finalize", False)]
        cfg = ctx.cfg
        self.ctx = ctx
        self.rate_metric = ctx.mix["rate_metric"]
        self.dev = ctx.device
        self.n = cfg["n_accessions"]
        self.rows = cfg["kinship_batch_rows"]
        self.table_rows = cfg["table_rows"]
        self.base = os.path.join(ctx.workdir, "t")
        self.dtable = self.base + ".dtable"
        self.results = []                   # (N, N) matrix of each job
        ctx.record["work"] = {"rows_per_job": self.table_rows,
                              "n_used": self.n}

    def setup(self, warm: bool = True) -> None:
        inputs.fresh_dir(self.ctx.workdir)
        inputs.write_table(self.base, self.n, self.table_rows,
                           self.ctx.cfg["kmer_len"], self.ctx.seed, self.dev)
        if warm:        # builds the dtable
            self._kinship()
        os.sync()       # the written files reach the disk before the window
        sync(self.dev)

    def _kinship(self):
        return self.kin_mod.kinship_from_table(
            self.base, device=self.dev, maf=self.ctx.cfg["maf"],
            batch_size=self.rows, dtable_cache=self.dtable,
            progress=lambda r: None)

    def job(self, i: int) -> int:
        self.results.append(self._kinship())
        return self.table_rows

    def traced_job(self, i: int) -> int:
        with patched_spans(self.span_targets):
            self._kinship()
        return self.table_rows

    def record(self) -> dict:
        return self.ctx.record

    def free(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def _reference(self, dtype=np.float64) -> np.ndarray:
        """The kinship of the table's rows that pass the MAF filter."""
        _, _, table = read_table(self.base)
        mc = ref.min_count(self.n, self.ctx.cfg["maf"])
        total, used = None, 0
        for b in range(0, table.shape[0], BLOCK):
            w = _words(table[b:b + BLOCK], self.dev)
            n1 = ref_scan.n1_of(w, self.n)
            keep = (n1 >= mc) & (self.n - n1 >= mc)
            g = ref.gram_pm1(w[keep])
            total = g if total is None else total.add_(g)
            used += int(keep.sum())
        return ref.normalize(total[:self.n, :self.n].cpu().numpy(), used,
                             dtype)

    def check(self, rng) -> dict:
        exact = self._reference()
        return {"kinship_gap": max(compare.kinship_gap(k, exact)
                                   for k in self.results)}

    def control(self, rng) -> dict:
        """The reference's counts normalized in float32 in the program's
        place, then the same check."""
        self.results = [self._reference(np.float32)]
        return self.check(rng)
