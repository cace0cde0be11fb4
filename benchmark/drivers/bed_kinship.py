"""The SNP EMMA kinship as a user runs it: `snps.kinship.
emma_kinship_from_bed` over a PLINK bed, the call that `kinship-bed` and
`gwas --kinship_snps` make, with its default chunk.

Set-up writes the bed, bim and fam (the configuration's snps over n_fam
accessions in a shuffled order, from the seed, with the SNP cell's writer,
bed_snps.write_bed) and runs one warm job. A job is the kinship of all
n_fam accessions over every SNP of the bed, the (n_fam, n_fam) float64
matrix on the host; jobs repeat with the bed in the page cache. The
`.kinship` file's write is left out. A job's rows are the bed's SNPs,
counted from the benchmark's own inputs: the check holds each answer to
every entry of the reference's matrix.

Off the card, a run takes the configuration's `cpu_sizes` in place of its
own: the benchmark's tests drive every cell on the CPU (tiny.py), and this
configuration has no row in tiny.py's table.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from benchmark import compare, inputs
from benchmark.drivers import sync
from benchmark.drivers.bed_snps import write_bed
from benchmark.reference import bedfile
from benchmark.reference import snp_kinship as ref


class Cell:
    def __init__(self, ctx):
        from kmersgwas_tpu_torch.snps import kinship
        self.kinship = kinship
        cfg = ctx.cfg
        if ctx.device.type != "cuda":
            cfg = {**cfg, **cfg.get("cpu_sizes", {})}
        self.ctx = ctx
        self.rate_metric = ctx.mix["rate_metric"]
        self.dev = ctx.device
        self.n_fam, self.m = cfg["n_fam"], cfg["snps"]
        self.base = os.path.join(ctx.workdir, "g")
        self.results = []           # each job's matrix
        ctx.record["work"] = {"rows": self.m, "n": self.n_fam}

    def setup(self, warm: bool = True) -> None:
        inputs.fresh_dir(self.ctx.workdir)
        # every fam accession is in the kinship
        write_bed(self.base, self.n_fam, self.n_fam, self.m, self.ctx.seed,
                  self.dev)
        if warm:
            self._run()
        os.sync()       # the written files reach the disk before the window
        sync(self.dev)

    def _run(self) -> np.ndarray:
        return self.kinship.emma_kinship_from_bed(self.base, device=self.dev)

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

    def _reference(self, dtype=torch.float64) -> np.ndarray:
        """The reference's kinship of the bed's bytes, on the card."""
        fam, rows = bedfile.read_bed(self.base)
        return ref.emma_kinship(rows, len(fam), self.dev,
                                dtype=dtype).cpu().numpy()

    def check(self, rng) -> dict:
        """Every job's matrix, each distinct one judged once (the jobs read
        the same bed, so a sound program gives one answer)."""
        exact = self._reference()
        gap, judged = 0.0, []
        for k in self.results:
            if any(np.array_equal(k, a) for a in judged):
                continue
            judged.append(k)
            gap = max(gap, compare.kinship_gap(k, exact))
        return {"kinship_gap": gap}

    def control(self, rng) -> dict:
        """The reference in the program's place with float32 products and
        sums, then the same check."""
        return {"kinship_gap": compare.kinship_gap(
            self._reference(torch.float32), self._reference())}
