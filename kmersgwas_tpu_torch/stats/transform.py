"""Phenotype transformation + permutation stage (port of
kmersgwas_tpu/stats/transform.py; src/R/transform_and_permute_phenotypes.R).

Center the phenotype, check the kinship is PSD, estimate the variance
components with REMLE, build V = vg K + ve I, draw `n_permutations`
covariance-preserving permutations and GRAMMAR-transform every column by
V^-1 (the reference's MASS::ginv; V is PD, so a Cholesky solve is the same
inverse). Returns the untransformed table (for the exact LMM) and the
transformed one (for the scan), the two files the R script writes (:87-88).

The whole stage runs in float64 on the host CPU, as the JAX package pins
it there (kmersgwas_tpu/pipeline/gwas.py:105-141): the work is n x n,
next to nothing beside the scan, and on the host a run on the card and a
run on the CPU feed the scan the same transformed table, bit for bit. This
is the placement, not a fallback: it does not depend on whether a card is
present.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import emma as emma_mod
from . import mvnpermute as mvn_mod

HOST = "cpu"


# copy of kmersgwas_tpu.stats.transform.TransformResult
@dataclass
class TransformResult:
    vg: float
    ve: float
    heritability: float
    names: list                  # column names: phenotype_value, P1..Pn
    phenotypes: np.ndarray       # (n, 1 + n_perm) centered, untransformed
    transformed: np.ndarray      # (n, 1 + n_perm) V^-1-transformed


def transform_and_permute(y: np.ndarray, K: np.ndarray, n_permutations: int,
                          seed: int = 0,
                          check_psd: bool = True) -> TransformResult:
    y = np.asarray(y, dtype=np.float64)
    K = np.asarray(K, dtype=np.float64)
    n = y.shape[0]
    yc = y - y.mean()

    if check_psd and not emma_mod.is_positive_semi_definite(K, device=HOST):
        raise ValueError("Kinship matrix is not positive semi-definite")

    res = emma_mod.remle(yc, K, device=HOST)
    vg, ve = float(res.vg), float(res.ve)
    V = vg * K + ve * np.eye(n)

    cols = [yc]
    if n_permutations > 0:
        perms = mvn_mod.mvnpermute(seed, yc, np.ones((n, 1)), V,
                                   n_permutations, device=HOST)
        cols.extend(perms.numpy().T)
    pheno = np.stack(cols, axis=1)       # (n, 1 + n_perm)

    # GRAMMAR transform: one Cholesky solve for all columns
    L = torch.linalg.cholesky(torch.from_numpy(V))
    trans = torch.cholesky_solve(torch.from_numpy(pheno), L).numpy()

    names = ["phenotype_value"] + [f"P{i}"
                                   for i in range(1, n_permutations + 1)]
    return TransformResult(vg=vg, ve=ve, heritability=vg / (vg + ve),
                           names=names, phenotypes=pheno, transformed=trans)


# copy of kmersgwas_tpu.stats.transform.permutation_threshold
def permutation_threshold(best_pvals: dict, n_permutations: int,
                          p: float) -> float:
    """Family-wise threshold from permutation best p-values.

    Reproduces functions.py:107-112: collect -log10(best p) of permutations
    P1..Pn, sort descending, take the int(n*p)-1 order statistic.
    """
    vals = [best_pvals[f"P{i}"] for i in range(1, n_permutations + 1)]
    vals.sort(reverse=True)
    return vals[int(n_permutations * p) - 1]
