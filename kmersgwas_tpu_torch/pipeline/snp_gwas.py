"""SNP arm of the GWAS pipeline (port of kmersgwas_tpu/pipeline/
snp_gwas.py; kmers_gwas.py:170-223).

Two modes, as in the reference:

  one_step  - the exact LMM on every usable SNP for every phenotype column
              (the reference farms GEMMA `-lmm 2` per column);
  two_steps - for the permutation columns, the GRAMMAR-Gamma scores
              (snps/assoc.py) prefilter each column's top-N SNPs and the
              exact LMM runs on those; the REAL phenotype column always
              gets the exact model on every usable SNP
              (kmers_gwas.py:175-178).

Missing genotypes are mean-dose imputed and SNPs outside the effective MAF
band or missing in more than half the samples are skipped, as GEMMA's
`-maf x -miss 0.5`.

The JAX package builds the (M, n) float64 dose matrix on the host (8.5 GB
at 2^20 SNPs x 1008 samples). Here the planes stay on the device and the
LMM's genotype feed (stats/lmm._scan_intercept's `genos(s, e)`) builds
each block of candidates' mean-imputed doses there, in float64, from the
packed planes: no (M, n) array exists on the host or the device.
"""
from __future__ import annotations

import math
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.bitplanes import unpack_bits
from ..snps.assoc import most_associated_snps
from ..snps.bed import SNPPlanes, load_bed_planes
from ..stats import lmm as lmm_mod
from ..stats.transform import permutation_threshold
from ..utils import require_device

F64 = torch.float64


def allele_freqs(planes: SNPPlanes):
    """-> (af, missing fraction) per SNP, float64 numpy: the mean dose
    over the observed samples (0 where none is), as the JAX package's
    _dose_matrix computes them."""
    total = planes.total.to(F64).cpu().numpy()
    s_gi = planes.s_gi.to(F64).cpu().numpy()
    af = np.where(total > 0, s_gi / np.maximum(total, 1), 0.0)
    return af, 1.0 - total / planes.n_samples


def dose_feed(planes: SNPPlanes, af: torch.Tensor, cand: torch.Tensor):
    """genos(s, e) for stats/lmm._scan_intercept: cand (C, m) SNP indices
    per column -> the (C, e - s, n) float64 mean-imputed doses of
    candidates s:e, missing genotypes at the SNP's af."""
    n = planes.n_samples

    def genos(s, e):
        idx = cand[:, s:e]

        def bits(plane):
            return unpack_bits(plane[idx], torch.uint8)[..., :n]
        dose = (bits(planes.presence) + 0.5 * bits(planes.het)).to(F64)
        return torch.where(bits(planes.nonmiss) > 0, dose,
                           af[idx][..., None])
    return genos


def _write_assoc(path, cand, bim_lines, af, lam, pvals) -> None:
    with open(path, "w") as f:
        f.write("chr\trs\tps\tn_miss\tallele1\tallele0\taf\tl_mle\tp_lrt\n")
        for i, s in enumerate(cand):
            tok = bim_lines[int(s)].split("\t")
            f.write(f"{tok[0]}\t{tok[1]}\t{tok[3]}\t0\t{tok[4]}\t{tok[5]}\t"
                    f"{af[s]:.6f}\t{10**lam[i]:.6e}\t{pvals[i]:.6e}\n")


def run_snp_arm(snps_matrix: str, outdir: str, used_accessions,
                pheno_untransformed: np.ndarray,
                pheno_transformed: np.ndarray, pheno_names,
                K_eigvals, K_eigvecs, *, mode: str, n_snps: int,
                maf: float, mac: float, n_permutations: int,
                lmm_grid: int = 64, lmm_refine: int = 40,
                device="cuda") -> dict:
    """-> {"thresholds", "best_pvals", "stage_seconds", "n_tests"}; writes
    the snps/ artifacts under `outdir`. Planes, scores and the LMM run on
    `device`, the LMM in float64."""
    if mode not in ("one_step", "two_steps"):
        raise ValueError(f"unknown SNP mode {mode!r}")
    dev = require_device(device)
    out = Path(outdir) / "snps"
    (out / "output").mkdir(parents=True, exist_ok=True)
    seconds = {}

    def lap(name, t0):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        seconds[f"snps.{name}"] = time.perf_counter() - t0
        return time.perf_counter()

    t = time.perf_counter()
    planes = load_bed_planes(snps_matrix, used_accessions, device=dev)
    n = planes.n_samples
    effective_maf = max(maf, float(mac) / n)
    af, miss_frac = allele_freqs(planes)
    usable = ((af >= effective_maf) & (af <= 1 - effective_maf)
              & (miss_frac <= 0.5))
    all_usable = np.nonzero(usable)[0]
    t = lap("planes", t)

    # candidates per column: every usable SNP, or (two_steps, permutation
    # columns) the column's top n_snps GRAMMAR scores that are usable
    p = len(pheno_names)
    cands = [all_usable] * p
    if mode == "two_steps" and p > 1:
        idx_lists, scores = most_associated_snps(
            planes, pheno_transformed[:, 1:].astype(np.float32),
            n_best=n_snps, maf=maf, mac=mac)
        del scores
        cands[1:] = [c[usable[c]] for c in idx_lists]
    t = lap("scores", t)

    # exact LMM: the real column alone (or with every column sharing its
    # candidates, one_step), the permutation columns together, each padded
    # to the longest candidate list with its own first candidate
    ys = torch.as_tensor(np.stack([y - y.mean()
                                   for y in pheno_untransformed.T]),
                         dtype=F64, device=dev)
    d = torch.as_tensor(K_eigvals, dtype=F64, device=dev)
    U = torch.as_tensor(K_eigvecs, dtype=F64, device=dev)
    af_dev = torch.as_tensor(af, dtype=F64, device=dev)
    groups = [list(range(p))] if mode == "one_step" \
        else [[0], list(range(1, p))]
    results = {}
    n_tests = 0
    for cols in groups:
        cols = [j for j in cols if len(cands[j])]
        if not cols:
            continue
        m = max(len(cands[j]) for j in cols)
        if mode == "one_step":
            cand = torch.as_tensor(all_usable, device=dev)[None]
            feed = dose_feed(planes, af_dev, cand)

            def genos(s, e, feed=feed, c=len(cols)):
                return feed(s, e).expand(c, -1, -1)
        else:
            pad = np.stack([np.concatenate(
                [cands[j], np.full(m - len(cands[j]), cands[j][0])])
                for j in cols])
            genos = dose_feed(planes, af_dev, torch.as_tensor(pad,
                                                              device=dev))
        res = lmm_mod._scan_intercept(genos, m, ys[cols], d, U, lmm_grid,
                                      lmm_refine)
        pv, lg = (f.cpu().numpy() for f in (res.p_lrt, res.log10_lambda))
        for i, j in enumerate(cols):
            k = len(cands[j])
            results[j] = (pv[i, :k], lg[i, :k])
            n_tests += k
    t = lap("lmm", t)

    with open(snps_matrix + ".bim") as f:
        bim_lines = f.read().splitlines()
    best_pvals = {}
    for j, cname in enumerate(pheno_names):
        if j not in results:
            best_pvals[cname] = 0.0
            continue
        pvals, lam = results[j]
        _write_assoc(out / "output" / f"{cname}.assoc.txt", cands[j],
                     bim_lines, af, lam, pvals)
        best_pvals[cname] = -math.log10(max(float(pvals.min()), 1e-300))
    del bim_lines

    th = {}
    if n_permutations:
        th["5per"] = permutation_threshold(best_pvals, n_permutations, 0.05)
        th["10per"] = permutation_threshold(best_pvals, n_permutations,
                                            0.10)
        (out / "threshold_5per").write_text(f"{th['5per']:f}\n")
        (out / "threshold_10per").write_text(f"{th['10per']:f}\n")
        # pass files from the real phenotype's assoc table, as written
        real = out / "output" / f"{pheno_names[0]}.assoc.txt"
        with open(real) as src, \
                open(out / "pass_threshold_5per", "w") as f5, \
                open(out / "pass_threshold_10per", "w") as f10:
            next(src)
            for ln in src:
                mlp = -math.log10(max(float(ln.split("\t")[8]), 1e-300))
                for f, frac in ((f5, th["5per"]), (f10, th["10per"])):
                    if mlp > frac:
                        f.write(ln)
    with open(out / "best_pvals", "w") as f:
        for name, v in best_pvals.items():
            f.write(f"{name}\t{v}\n")
    lap("artifacts", t)
    return {"thresholds": th, "best_pvals": best_pvals,
            "stage_seconds": seconds, "n_tests": n_tests}
