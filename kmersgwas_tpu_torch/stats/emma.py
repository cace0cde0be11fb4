"""EMMA REML variance-component estimation in PyTorch (port of the REML
part of kmersgwas_tpu/stats/emma.py).

`emma.REMLE` (src/R/emma.R:392-493) as batched tensor code in float64:
eigendecomposition of S(K+I)S once, the restricted log-likelihood's
derivative on a 101-point log-delta grid, and 60 bisection steps in every
cell with a (+, -) sign change, all cells at once (masked), in place of R's
`uniroot` (emma.R:432-440). The candidate with the highest REML LL wins.

The rest of the JAX module (full ML, the rotated solvers, `emma_ML_LRT`,
`emma_REML_t`, `emma_kinship`) is not ported yet: no entry point of the
pipeline calls it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..utils import require_device

F64 = torch.float64


class REMLEResult(NamedTuple):
    reml_ll: torch.Tensor
    delta: torch.Tensor
    vg: torch.Tensor
    ve: torch.Tensor


def as_f64(x, device) -> torch.Tensor:
    """x as a float64 tensor on `device` (no copy when it already is)."""
    return torch.as_tensor(x, dtype=F64, device=device)


def eigen_R(K: torch.Tensor, X: torch.Tensor):
    """Eigen-system of S(K+I)S with S = I - X(X'X)^-1 X' (emma.R:85-92).

    Returns (values (n-q,), vectors (n, n-q)) in descending eigenvalue
    order, eigenvalues shifted by -1 as the reference does."""
    n, q = X.shape
    eye = torch.eye(n, dtype=K.dtype, device=K.device)
    S = eye - X @ torch.linalg.solve(X.T @ X, X.T)
    w, v = torch.linalg.eigh(S @ (K + eye) @ S)           # ascending
    return w.flip(0)[: n - q] - 1.0, v.flip(1)[:, : n - q]


def _dLL(logdelta, lam, etasq):
    """Derivative of the restricted LL wrt log-delta (emma.R:158-164), at
    every entry of `logdelta` (any shape)."""
    nq = lam.shape[0]
    delta = torch.exp(logdelta)[..., None]
    ld = lam + delta
    return 0.5 * delta[..., 0] * (
        nq * torch.sum(etasq / (ld * ld), -1) / torch.sum(etasq / ld, -1)
        - torch.sum(1.0 / ld, -1))


def _LL(logdelta, lam, etasq):
    """Restricted LL at log-delta (emma.R:145-149), at every entry."""
    nq = lam.shape[0]
    ld = lam + torch.exp(logdelta)[..., None]
    return 0.5 * (nq * (math.log(nq / (2 * math.pi)) - 1.0
                        - torch.log(torch.sum(etasq / ld, -1)))
                  - torch.sum(torch.log(ld), -1))


def remle_from_eigen(etas: torch.Tensor, lam: torch.Tensor,
                     llim: float = -10.0, ulim: float = 10.0,
                     esp: float = 1e-10, ngrids: int = 100,
                     n_bisect: int = 60) -> REMLEResult:
    """REMLE given etas = R_vectors' y and eigenvalues lam (n-q,)."""
    nq = lam.shape[0]
    etasq = etas * etas
    logdelta = torch.linspace(llim, ulim, ngrids + 1, dtype=lam.dtype,
                              device=lam.device)
    dll = _dLL(logdelta, lam, etasq)

    # bisection in every grid cell with a (+, -) sign change, all at once
    lo, hi = logdelta[:-1], logdelta[1:]
    cell_ok = (dll[:-1] * dll[1:] < -esp * esp) & (dll[:-1] > 0) \
        & (dll[1:] < 0)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        up = _dLL(mid, lam, etasq) > 0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    roots = 0.5 * (lo + hi)

    ends = torch.tensor([llim, ulim], dtype=lam.dtype, device=lam.device)
    cand_logdelta = torch.cat([ends, roots])
    cand_ll = _LL(cand_logdelta, lam, etasq)
    cand_ok = torch.cat([(dll[0] < esp)[None], (dll[-1] > -esp)[None],
                         cell_ok])
    masked_ll = torch.where(cand_ok, cand_ll,
                            torch.full_like(cand_ll, -math.inf))
    # first maximum, as jnp.argmax (also when every entry is -inf)
    best = torch.argmax(masked_ll)
    maxdelta = torch.exp(cand_logdelta[best])
    vg = torch.sum(etasq / (lam + maxdelta)) / nq
    return REMLEResult(reml_ll=masked_ll[best], delta=maxdelta, vg=vg,
                       ve=vg * maxdelta)


def _apply_Z(K, Z):
    """emma's Z incidence matrix (emma.R:398-400): the model with random
    effects Z u, u ~ N(0, vg K), equals the no-Z model with K_eff = Z K Z'
    (see the JAX module's note)."""
    return K if Z is None else Z @ K @ Z.T


def remle(y, K, X=None, Z=None, *, device="cuda") -> REMLEResult:
    """emma.REMLE(y, X, K, Z) in float64 on `device`, X defaulting to the
    intercept column."""
    dev = require_device(device)
    y = as_f64(y, dev)
    K = _apply_Z(as_f64(K, dev), None if Z is None else as_f64(Z, dev))
    n = y.shape[0]
    X = torch.ones((n, 1), dtype=F64, device=dev) if X is None \
        else as_f64(X, dev)
    lam, vec = eigen_R(K, X)
    return remle_from_eigen(vec.T @ y, lam)


def heritability(res: REMLEResult) -> torch.Tensor:
    return res.vg / (res.vg + res.ve)


def is_positive_semi_definite(K, tol: float = 1e-8, *,
                              device="cuda") -> bool:
    """PSD gate on the kinship matrix
    (transform_and_permute_phenotypes.R:54-57)."""
    w = torch.linalg.eigvalsh(as_f64(K, require_device(device)))
    return bool(w.min() >= -tol * max(1.0, float(w.max())))
