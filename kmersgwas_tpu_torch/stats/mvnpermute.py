"""Covariance-preserving phenotype permutations (port of
kmersgwas_tpu/stats/mvnpermute.py, the R package `mvnpermute` that
src/R/transform_and_permute_phenotypes.R:74-78 calls):

  1. GLS fit of fixed effects:  b = (X' V^-1 X)^-1 X' V^-1 y
  2. whiten the residuals:      z = L^-1 (y - Xb)   with V = L L'
  3. permute z, re-color:       y* = Xb + L P z

The permutation indices come from `numpy.random.Generator(seed)`
(`draw_permutations`); the JAX package draws them with
`jax.random.permutation`, which torch cannot reproduce, so the two
packages' replicates differ for the same seed. Given the same indices they
agree.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import require_device
from .emma import as_f64


def draw_permutations(seed: int, nr: int, n: int) -> np.ndarray:
    """(nr, n) int64: nr independent permutations of range(n)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.permutation(n) for _ in range(nr)]).astype(
        np.int64).reshape(nr, n)


def mvnpermute(seed: int, y, X, V, nr: int, *, device="cuda"):
    """-> (n, nr) float64 permutation replicates of y under covariance V."""
    dev = require_device(device)
    y, X, V = as_f64(y, dev), as_f64(X, dev), as_f64(V, dev)
    n = y.shape[0]
    L = torch.linalg.cholesky(V)
    Vinv_X = torch.cholesky_solve(X, L)
    b = torch.linalg.solve(X.T @ Vinv_X, Vinv_X.T @ y)
    fix = X @ b
    z = torch.linalg.solve_triangular(L, (y - fix)[:, None],
                                      upper=False)[:, 0]
    idx = torch.tensor(draw_permutations(seed, nr, n), device=dev)
    return fix[:, None] + L @ z[idx].T
