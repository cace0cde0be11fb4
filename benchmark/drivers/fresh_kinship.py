"""The EMMA kinship over fresh generated rows: the port's accumulator with
the host feed out of the way.

A job is `ops.kinship.KinshipAccumulator(n_used, n_pad)`, one `.add` per
batch of the configuration's kinship_batch_rows rows over its whole table
(ceil(kmers / kinship_batch_rows) batches), then `.finalize` (the matrix
on the host). Batch b of job i is the benchmark generator's batch
i * batches + b, planes only.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from benchmark import compare, gen, inputs
from benchmark.drivers import sync
from benchmark.reference import kinship as ref
from benchmark.trace import span


class Cell:
    def __init__(self, ctx):
        from kmersgwas_tpu_torch.ops import kinship
        self.kin = kinship
        cfg = ctx.cfg
        self.ctx = ctx
        self.rate_metric = ctx.mix["rate_metric"]
        self.dev = ctx.device
        self.n = cfg["n_accessions"]
        self.rows = cfg["kinship_batch_rows"]
        self.batches = math.ceil(cfg["kmers"] / self.rows)
        self.w32 = inputs.lanes_w32(self.n)
        self.key = inputs.subseed(ctx.seed, "kinship_planes")
        self.results = []               # (job, (N, N) matrix)
        self._totals = {}
        ctx.record["work"] = {"rows_per_job": self.batches * self.rows,
                              "n_used": self.n, "w32": self.w32}

    def setup(self, warm: bool = True) -> None:
        if warm:
            self._job(0, self.ctx.mix["warm_batches"],
                      inputs.subseed(self.ctx.seed, "warm"))
        sync(self.dev)

    def _job(self, i: int, n_batches: int, key: int):
        acc = self.kin.KinshipAccumulator(n_used=self.n, n_pad=32 * self.w32,
                                          device=self.dev)
        for b in range(n_batches):
            planes = gen.gen_planes(self.rows, self.w32, key,
                                    i * self.batches + b, self.dev,
                                    popcount=False)
            with span("add"):
                acc.add(planes)
        with span("finalize"):
            return acc.finalize()

    def job(self, i: int) -> int:
        self.results.append((i, self._job(i, self.batches, self.key)))
        return self.batches * self.rows

    def traced_job(self, i: int) -> int:
        self._job(i, self.batches, self.key)
        return self.batches * self.rows

    def record(self) -> dict:
        return self.ctx.record

    def free(self) -> None:
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    # ------------------------------------------------------------ the check

    def _total(self, i: int) -> np.ndarray:
        """The reference's int64 +-1 Gram of job i's rows, used samples."""
        if i not in self._totals:
            t = None
            for b in range(self.batches):
                planes = gen.gen_planes(self.rows, self.w32, self.key,
                                        i * self.batches + b, self.dev,
                                        popcount=False)
                g = ref.gram_pm1(planes)
                t = g if t is None else t.add_(g)
            self._totals[i] = t[:self.n, :self.n].cpu().numpy()
        return self._totals[i]

    def check(self, rng) -> dict:
        i, k = self.results[int(rng.integers(len(self.results)))]
        exact = ref.normalize(self._total(i), self.batches * self.rows)
        return {"kinship_gap": compare.kinship_gap(k, exact)}

    def control(self, rng) -> dict:
        """Job 0's matrix from the reference's counts normalized in float32
        in the program's place, then the same check."""
        k32 = ref.normalize(self._total(0), self.batches * self.rows,
                            np.float32)
        self.results = [(0, k32)]
        return self.check(rng)
