"""EMMA variance components and per-variant tests in PyTorch (port of
kmersgwas_tpu/stats/emma.py; the vendored EMMA library, src/R/emma.R).

Everything runs as batched float64 tensor code on `device` ("cuda" by
default, as the rest of the port), where the JAX package vmaps:

  * `remle` / `mle` (emma.REMLE, emma.MLE; emma.R:176-289, 392-493): the
    eigendecomposition of S(K+I)S once, the log-likelihood's derivative on
    a 101-point log-delta grid, and 60 bisection steps in every cell with
    a (+, -) sign change, all cells at once (masked), in place of R's
    `uniroot` (emma.R:432-440). The candidate with the highest LL wins.
  * `emma_ML_LRT`, `emma_REML_t` (emma.R:495-741, 1013-1274), `mle_noX`
    and `emma_test`: one eigh(K) and the rotated likelihoods (the JAX
    module's notes give the identities) over (variants, phenotypes) at
    once, in chunks of variants. The JAX package takes dLL by jax.grad;
    here it is the closed form of the same derivative,
      d ML/d log delta   = delta/2 (n sum w^2 e^2 / y'Py - sum w),
      d REML/d log delta = delta/2 ((n-q) sum w^2 e^2 / y'Py - sum w
                                    + tr(G^-1 X' W^2 X)),
    with w = 1/(xi + delta), e = y - X beta, G = X' W X. Missing data
    follow R's subsetting: a NaN in a ys row subsets that row's
    individuals; a variant with NaNs is re-run on its own complete
    individuals, the variants gathered by subset size as the JAX package
    does (`_na_tail_by_size`), one eigendecomposition per distinct subset.
  * `emma_kinship` (emma.R:1-47) as two GEMMs.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
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


def _grid_search(fn, batch, like, llim, ulim, esp, ngrids, n_bisect,
                 n_cells):
    """emma.R's maximizer (emma.R:414-452) for a batch of likelihoods:
    fn(logdelta (batch + (k,))) -> (LL, dLL/dlogdelta), each batch +
    (k,). dLL on ngrids + 1 log-delta points; bisection in the first
    n_cells cells (ascending) with a (+, -) sign change; the best of the
    two ends and the roots by LL, the first on ties. -> (logdelta, LL),
    each `batch`."""
    logdelta = torch.linspace(llim, ulim, ngrids + 1, dtype=like.dtype,
                              device=like.device)
    dll = fn(logdelta.expand(*batch, -1))[1]
    cell_ok = (dll[..., :-1] * dll[..., 1:] < -esp * esp) \
        & (dll[..., :-1] > 0) & (dll[..., 1:] < 0)
    # the first n_cells sign-change cells, ascending
    ar = torch.arange(ngrids, device=like.device)
    sel = torch.argsort(torch.where(cell_ok, ar, ngrids + ar),
                        -1)[..., :n_cells]
    lo, hi = logdelta[sel], logdelta[sel + 1]
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        up = fn(mid)[1] > 0
        lo, hi = torch.where(up, mid, lo), torch.where(up, hi, mid)
    ends = torch.tensor([llim, ulim], dtype=like.dtype, device=like.device)
    cand = torch.cat([ends.expand(*batch, 2), 0.5 * (lo + hi)], -1)
    cand_ok = torch.cat([dll[..., :1] < esp, dll[..., -1:] > -esp,
                         cell_ok.gather(-1, sel)], -1)
    masked = torch.where(cand_ok, fn(cand)[0],
                         torch.full_like(cand, -math.inf))
    # first maximum, as jnp.argmax (also when every entry is -inf)
    best = torch.argmax(masked, -1, keepdim=True)
    return cand.gather(-1, best)[..., 0], masked.gather(-1, best)[..., 0]


def remle_from_eigen(etas: torch.Tensor, lam: torch.Tensor,
                     llim: float = -10.0, ulim: float = 10.0,
                     esp: float = 1e-10, ngrids: int = 100,
                     n_bisect: int = 60) -> REMLEResult:
    """REMLE given etas = R_vectors' y and eigenvalues lam (n-q,)."""
    nq = lam.shape[0]
    etasq = etas * etas
    best, ll = _grid_search(
        lambda g: (_LL(g, lam, etasq), _dLL(g, lam, etasq)), (), lam,
        llim, ulim, esp, ngrids, n_bisect, ngrids)
    maxdelta = torch.exp(best)
    vg = torch.sum(etasq / (lam + maxdelta)) / nq
    return REMLEResult(reml_ll=ll, delta=maxdelta, vg=vg, ve=vg * maxdelta)


def _apply_Z(K, Z):
    """emma's Z incidence matrix (emma.R:398-400): the model with random
    effects Z u, u ~ N(0, vg K), equals the no-Z model with K_eff = Z K Z'
    (see the JAX module's note)."""
    return K if Z is None else Z @ K @ Z.T


def _k_eff(K, Z, dev):
    return _apply_Z(as_f64(K, dev), None if Z is None else as_f64(Z, dev))


def _design(y, K, X, Z, device):
    """(y, K_eff, X) float64 on `device`, X defaulting to the intercept
    column."""
    dev = require_device(device)
    y = as_f64(y, dev)
    X = torch.ones((y.shape[0], 1), dtype=F64, device=dev) if X is None \
        else as_f64(X, dev)
    return y, _k_eff(K, Z, dev), X


def remle(y, K, X=None, Z=None, *, device="cuda") -> REMLEResult:
    """emma.REMLE(y, X, K, Z) in float64 on `device`, X defaulting to the
    intercept column."""
    y, K, X = _design(y, K, X, Z, device)
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


# ---------------------------------------------------------------------------
# Full maximum likelihood (emma.MLE, emma.R:176-289): not on the pipeline's
# path (REML + the per-variant ML-LRT of stats/lmm.py), part of the EMMA API
# ---------------------------------------------------------------------------

def _ml_LL(logdelta, lam_R, etasq, xi):
    n = xi.shape[0]
    delta = torch.exp(logdelta)[..., None]
    return 0.5 * (n * (math.log(n / (2 * math.pi)) - 1.0
                       - torch.log(torch.sum(etasq / (lam_R + delta), -1)))
                  - torch.sum(torch.log(xi + delta), -1))


def _ml_dLL(logdelta, lam_R, etasq, xi):
    """d ML / d delta (emma.R:126-131), as the JAX package evaluates it."""
    n = xi.shape[0]
    delta = torch.exp(logdelta)[..., None]
    ld = lam_R + delta
    return 0.5 * (n * torch.sum(etasq / (ld * ld), -1)
                  / torch.sum(etasq / ld, -1)
                  - torch.sum(1.0 / (xi + delta), -1))


def mle_from_eigen(etas, lam_R, xi, llim: float = -10.0, ulim: float = 10.0,
                   esp: float = 1e-10, ngrids: int = 100,
                   n_bisect: int = 60) -> REMLEResult:
    """emma.MLE's search given etas, the restricted eigenvalues lam_R and
    the kinship's eigenvalues xi (emma.R:176-244)."""
    n = xi.shape[0]
    etasq = etas * etas
    best, ll = _grid_search(
        lambda g: (_ml_LL(g, lam_R, etasq, xi),
                   _ml_dLL(g, lam_R, etasq, xi)), (), xi,
        llim, ulim, esp, ngrids, n_bisect, ngrids)
    maxdelta = torch.exp(best)
    vg = torch.sum(etasq / (lam_R + maxdelta)) / n
    return REMLEResult(reml_ll=ll, delta=maxdelta, vg=vg, ve=vg * maxdelta)


def mle(y, K, X=None, Z=None, *, device="cuda") -> REMLEResult:
    """emma.MLE(y, X, K, Z): full-ML variance components (Z as in remle),
    in float64 on `device`."""
    y, K, X = _design(y, K, X, Z, device)
    lam_R, vec = eigen_R(K, X)
    xi = torch.linalg.eigvalsh(K).flip(0)
    return mle_from_eigen(vec.T @ y, lam_R, xi)


# ---------------------------------------------------------------------------
# The rotated likelihoods: K = U diag(xi) U' once, every quantity an O(n q^2)
# weighted sum with w = 1/(xi + delta). Arguments broadcast: logdelta has
# the batch shape B, xi (..., n), Xt (..., n, q) and yt (..., n) broadcast
# against B.
# ---------------------------------------------------------------------------

def _rot_stats(logdelta, xi, Xt, yt):
    """At every log-delta: w = 1/(xi+delta), G = X'Hinv X, beta = G^-1
    X'Hinv y, y'Py, and the residual e = y - X beta."""
    w = 1.0 / (xi + torch.exp(logdelta)[..., None])
    Xw = Xt * w[..., None]
    G = Xt.transpose(-1, -2) @ Xw
    r = (Xw * yt[..., None]).sum(-2)
    # a monomorphic variant makes G singular: its entries come out inf or
    # NaN, as jnp.linalg.solve's, and are masked by the callers
    beta = torch.linalg.solve_ex(G, r)[0]
    yPy = (w * yt * yt).sum(-1) - (r * beta).sum(-1)
    return w, G, beta, yPy, yt - (Xt @ beta[..., None])[..., 0]


def _ml_rot(logdelta, xi, Xt, yt):
    """Full-ML LL (emma.R:120-124 on the rotated system) and its
    derivative in log-delta."""
    n = Xt.shape[-2]
    delta = torch.exp(logdelta)
    w, _, _, yPy, e = _rot_stats(logdelta, xi, Xt, yt)
    ll = 0.5 * (n * (math.log(n / (2 * math.pi)) - 1.0 - torch.log(yPy))
                - torch.log(xi + delta[..., None]).sum(-1))
    dll = 0.5 * delta * (n * (w * w * e * e).sum(-1) / yPy - w.sum(-1))
    return ll, dll


def _reml_rot(logdelta, xi, Xt, yt, logdet_XtX):
    """Restricted LL (emma.R:145-149 on the eigen_R system of S(K+I)S with
    X = the columns of Xt) and its derivative in log-delta."""
    n, q = Xt.shape[-2:]
    nq = n - q
    delta = torch.exp(logdelta)
    w, G, _, yPy, e = _rot_stats(logdelta, xi, Xt, yt)
    logdet_shs = torch.log(xi + delta[..., None]).sum(-1) \
        + torch.linalg.slogdet(G)[1] - logdet_XtX
    ll = 0.5 * (nq * (math.log(nq / (2 * math.pi)) - 1.0 - torch.log(yPy))
                - logdet_shs)
    XwwX = Xt.transpose(-1, -2) @ (Xt * (w * w)[..., None])
    trace = torch.linalg.solve_ex(G, XwwX)[0].diagonal(0, -2, -1).sum(-1)
    dll = 0.5 * delta * (nq * (w * w * e * e).sum(-1) / yPy - w.sum(-1)
                         + trace)
    return ll, dll


def _batch(xi, Xt, yt):
    return torch.broadcast_shapes(xi.shape[:-1], Xt.shape[:-2],
                                  yt.shape[:-1])


def _grid_opt_rot(ll_fn, batch, like, llim, ulim, esp, ngrids, n_bisect,
                  n_cells=8):
    """The maximizer of the rotated likelihoods: the same search as
    remle_from_eigen, up to n_cells sign-change cells refined (R refines
    every one; more than a few stationary points never occur for these
    likelihoods). ll_fn(logdelta (batch + (k,))) -> (LL, dLL)."""
    return _grid_search(ll_fn, batch, like, llim, ulim, esp, ngrids,
                        n_bisect, n_cells)


def _k_axis(xi, Xt, yt):
    """The arguments with an axis for the k log-deltas of one search."""
    return xi[..., None, :], Xt[..., None, :, :], yt[..., None, :]


def _remle_rot(xi, Xt, yt, llim, ulim, esp, ngrids,
               n_bisect) -> REMLEResult:
    n, q = Xt.shape[-2:]
    logdet_XtX = torch.linalg.slogdet(Xt.transpose(-1, -2) @ Xt)[1]
    xk, Xk, yk = _k_axis(xi, Xt, yt)
    best, ll = _grid_opt_rot(
        lambda g: _reml_rot(g, xk, Xk, yk, logdet_XtX[..., None]),
        _batch(xi, Xt, yt), yt, llim, ulim, esp, ngrids, n_bisect)
    delta = torch.exp(best)
    vg = _rot_stats(best, xi, Xt, yt)[3] / (n - q)
    return REMLEResult(reml_ll=ll, delta=delta, vg=vg, ve=vg * delta)


def _mle_rot(xi, Xt, yt, llim, ulim, esp, ngrids, n_bisect) -> REMLEResult:
    n = Xt.shape[-2]
    xk, Xk, yk = _k_axis(xi, Xt, yt)
    best, ll = _grid_opt_rot(lambda g: _ml_rot(g, xk, Xk, yk),
                             _batch(xi, Xt, yt), yt, llim, ulim, esp,
                             ngrids, n_bisect)
    delta = torch.exp(best)
    vg = _rot_stats(best, xi, Xt, yt)[3] / n
    return REMLEResult(reml_ll=ll, delta=delta, vg=vg, ve=vg * delta)


def emma_kinship(snps, method: str = "additive", use: str = "all", *,
                 device="cuda") -> torch.Tensor:
    """emma.kinship: SNP matrix (m markers x n individuals, values in
    {0, 0.5, 1, NaN}) -> (n, n) similarity kinship, float64 on `device`.

    K[i,j] = mean over markers of x_i x_j + (1-x_i)(1-x_j); hets resolved
    to major/minor per `method`; NaNs mean-imputed (`use="all"`) or their
    markers dropped (`use="complete.obs"`). Two GEMMs replace R's
    O(n^2 m) pair loop (emma.R:40-46)."""
    S = as_f64(snps, require_device(device))
    isna = torch.isnan(S)
    row_mean = torch.nanmean(S, 1, keepdim=True)
    het = ~isna & (S == 0.5)
    major, minor = (row_mean > 0.5).to(F64), (row_mean < 0.5).to(F64)
    if method == "dominant":
        S = torch.where(het, major, S)
    elif method == "recessive":
        S = torch.where(het, minor, S)
    elif method == "additive":
        S = torch.cat([torch.where(het, major, S),
                       torch.where(het, minor, S)])
    else:
        raise ValueError(f"unknown method {method!r}")
    if use == "all":
        S = torch.where(torch.isnan(S), torch.nanmean(S, 1, keepdim=True), S)
    elif use == "complete.obs":
        S = S[~torch.isnan(S).any(1)]
    else:
        raise ValueError(f"unknown use {use!r}")
    K = (S.T @ S + (1.0 - S).T @ (1.0 - S)) / S.shape[0]
    return K.fill_diagonal_(1.0)


# elements of one chunk of a core's search, which holds a few (variants,
# g, 101, n, q) float64 tensors
_EMMA_CHUNK_ELEMS = 1 << 24


def _in_chunks(fn, m, elems_per_variant):
    """fn(s, e) over chunks of m variants, its results (tuples of tensors
    with the variants first) concatenated."""
    step = max(1, _EMMA_CHUNK_ELEMS // max(1, elems_per_variant))
    parts = [fn(s, min(m, s + step)) for s in range(0, max(m, 1), step)]
    return [torch.cat(f) for f in zip(*parts)]


def _with_variant(X0t, xt):
    """[X0, x] rotated: X0t (..., n, q0) and xt (..., n) -> (..., n, q0+1)
    over their broadcast batch."""
    batch = torch.broadcast_shapes(X0t.shape[:-2], xt.shape[:-1])
    return torch.cat([X0t.expand(*batch, *X0t.shape[-2:]),
                      xt.expand(*batch, xt.shape[-1])[..., None]], -1)


def _ml_lrt_rot(xi, X0t, xt, yt, llim, ulim, ngrids, n_bisect):
    """ML-LRT pieces on the rotated system -> (ml1, vg, ve, ml0); the
    null over (X0t, yt)'s batch, the alternative over (xt, yt)'s."""
    r0 = _mle_rot(xi, X0t, yt, llim, ulim, 1e-10, ngrids, n_bisect)
    r1 = _mle_rot(xi, _with_variant(X0t, xt), yt, llim, ulim, 1e-10,
                  ngrids, n_bisect)
    return r1.reml_ll, r1.vg, r1.ve, r0.reml_ll


def _reml_t_rot(xi, X0t, xt, yt, llim, ulim, ngrids, n_bisect):
    """REML Wald t on the rotated system -> (stat, vg, ve, reml): REMLE
    under X = [X0, x], then stat = beta_x / sqrt((X'Hinv X)^-1[-1,-1] vg),
    the same as rotating by U = Q diag(1/sqrt(xi+delta)) (emma.R:1089-1101,
    1160-1164)."""
    Xt = _with_variant(X0t, xt)
    res = _remle_rot(xi, Xt, yt, llim, ulim, 1e-10, ngrids, n_bisect)
    _, G, beta, _, _ = _rot_stats(torch.log(res.delta), xi, Xt, yt)
    iXXqq = torch.linalg.inv_ex(G)[0][..., -1, -1]
    return (beta[..., -1] / torch.sqrt(iXXqq * res.vg), res.vg, res.ve,
            res.reml_ll)


def _complete(core, ys, xs, K, X0, llim, ulim, ngrids, n_bisect):
    """A core over complete data: one eigh(K), every (variant, phenotype)
    -> four (m, g) tensors."""
    xi, U = torch.linalg.eigh(K)                     # order irrelevant here
    yts, xts, X0t = ys @ U, xs @ U, U.T @ X0
    m, g = xs.shape[0], ys.shape[0]

    def chunk(s, e):
        out = core(xi, X0t, xts[s:e, None, :], yts[None], llim, ulim,
                   ngrids, n_bisect)
        return [v.expand(e - s, g) for v in out]
    return _in_chunks(chunk, m, g * (ngrids + 1) * K.shape[0]
                      * (X0.shape[1] + 1))


def _gathered(core, y, xs_b, K, X0, keys, inverse, llim, ulim, ngrids,
              n_bisect):
    """A core over b variants that each keep their own complete
    individuals, s of them: xs_b (b, s) the variants there, keys (u, s)
    the distinct subsets' indices and inverse (b,) each variant's. One
    batched eigh of the u sub-kinships -> four (b,) tensors."""
    xi, U = torch.linalg.eigh(K[keys[:, :, None], keys[:, None, :]])
    xt = torch.empty_like(xs_b)
    for u in range(keys.shape[0]):
        rows = inverse == u
        xt[rows] = xs_b[rows] @ U[u]
    yt = (y[keys][:, None, :] @ U)[:, 0][inverse]
    X0t = (U.transpose(-1, -2) @ X0[keys])[inverse]
    xi = xi[inverse]
    return _in_chunks(
        lambda s, e: core(xi[s:e], X0t[s:e], xt[s:e], yt[s:e], llim, ulim,
                          ngrids, n_bisect),
        xs_b.shape[0], (ngrids + 1) * keys.shape[1] * (X0.shape[1] + 1))


# copy of kmersgwas_tpu.stats.emma._na_tail_by_size
def _na_tail_by_size(na_idx, vids, xs_na):
    """Group NA-variant indices by their gathered subset SIZE; returns
    {size: (idxs list, masks list)} with masks = vids & ~xs_na[i]."""
    by_size: dict = {}
    for i in na_idx:
        vv = vids & ~xs_na[i]
        by_size.setdefault(int(vv.sum()), ([], []))
        by_size[int(vv.sum())][0].append(int(i))
        by_size[int(vv.sum())][1].append(vv)
    return by_size


def _run_tests(core, ys, xs, K, Z, X0, llim, ulim, ngrids, n_bisect, device):
    """The shared body of emma_ML_LRT and emma_REML_t: complete data in
    one pass; otherwise per phenotype row its complete individuals, the
    variants without NaNs there in one pass and the rest gathered by subset
    size (emma.R:611-614, 683-691). -> (four (m, g) tensors, the (m, g)
    sizes of the subsets, xs)."""
    dev = require_device(device)
    ys_h = np.atleast_2d(np.asarray(ys, np.float64))
    xs_h = np.atleast_2d(np.asarray(xs, np.float64))
    ys, xs = as_f64(ys_h, dev), as_f64(xs_h, dev)
    K = _k_eff(K, Z, dev)
    m, g = xs.shape[0], ys.shape[0]
    X0 = torch.ones((ys.shape[1], 1), dtype=F64, device=dev) if X0 is None \
        else as_f64(X0, dev)
    ys_na, xs_na = np.isnan(ys_h), np.isnan(xs_h)
    if not ys_na.any() and not xs_na.any():
        return (_complete(core, ys, xs, K, X0, llim, ulim, ngrids,
                          n_bisect),
                torch.full((m, g), ys.shape[1], dtype=F64, device=dev), xs)
    outs = [torch.full((m, g), math.nan, dtype=F64, device=dev)
            for _ in range(5)]
    for j in range(g):
        vids = ~ys_na[j]
        v = torch.as_tensor(np.flatnonzero(vids), device=dev)
        clean = ~xs_na[:, vids].any(axis=1)
        if clean.any():
            c = torch.as_tensor(np.flatnonzero(clean), device=dev)
            r = _complete(core, ys[j:j + 1, v], xs[c][:, v], K[v][:, v],
                          X0[v], llim, ulim, ngrids, n_bisect)
            for o, val in zip(outs, r):
                o[c, j] = val[:, 0]
            outs[4][c, j] = float(vids.sum())
        # the NA variants, one batch per subset size
        for s, (idxs, masks) in _na_tail_by_size(
                np.flatnonzero(~clean), vids, xs_na).items():
            keys, inverse = np.unique(np.stack(masks), axis=0,
                                      return_inverse=True)

            def where_true(bm):
                return torch.as_tensor(
                    np.stack([np.flatnonzero(r) for r in bm]), device=dev)
            i = torch.as_tensor(idxs, device=dev)
            r = _gathered(core, ys[j], xs[i[:, None], where_true(masks)], K,
                          X0, where_true(keys),
                          torch.as_tensor(inverse.reshape(-1), device=dev),
                          llim, ulim, ngrids, n_bisect)
            for o, val in zip(outs, r):
                o[i, j] = val
            outs[4][i, j] = float(s)
    return outs[:4], outs[4], xs


def _monomorphic(xs):
    """(m, 1): variants whose mean over the observed entries is 0 or 1
    (emma.R:541-555)."""
    x_mean = torch.nanmean(xs, 1)
    return ((x_mean <= 0) | (x_mean >= 1))[:, None]


def emma_ML_LRT(ys, xs, K, Z=None, X0=None, ngrids: int = 100,
                llim: float = -10.0, ulim: float = 10.0, n_bisect: int = 60,
                *, device="cuda") -> dict:
    """emma.ML.LRT: per-variant ML likelihood-ratio test (emma.R:495-741).

    ys (g, n) or (n,) phenotypes, xs (m, n) variants, K (n, n). Returns a
    dict of (m, g) float64 tensors on `device`: ps, stats, ML1s, ML0s,
    vgs, ves. Monomorphic variants get p = 1. NaNs follow R's subsetting
    (module docstring)."""
    from .lmm import chi2_sf_df1
    (ml1, vg, ve, ml0), _, xs = _run_tests(
        _ml_lrt_rot, ys, xs, K, Z, X0, llim, ulim, ngrids, n_bisect, device)
    mono = _monomorphic(xs)
    nan = torch.tensor(math.nan, dtype=F64, device=xs.device)
    stat = torch.where(mono, nan, 2.0 * (ml1 - ml0))
    return {"ps": torch.where(mono, 1.0, chi2_sf_df1(torch.maximum(
                stat, torch.zeros_like(stat)))),
            "stats": stat,
            "ML1s": torch.where(mono, nan, ml1),
            "ML0s": ml0,
            "vgs": torch.where(mono, nan, vg),
            "ves": torch.where(mono, nan, ve)}


def _betacf(a, b, x, n_iter: int = 300):
    """Continued fraction of the incomplete beta function (modified
    Lentz), a fixed number of steps: it converges in O(sqrt(max(a, b)))
    where x < (a + 1) / (a + b + 2), the only place it is used."""
    tiny = 1e-300

    def fix(v):
        return torch.where(v.abs() < tiny, tiny, v)
    c = torch.ones_like(x)
    d = 1.0 / fix(1.0 - (a + b) * x / (a + 1.0))
    h = d
    for k in range(1, n_iter + 1):
        for aa in (k * (b - k) * x / ((a - 1.0 + 2 * k) * (a + 2 * k)),
                   -(a + k) * (a + b + k) * x
                   / ((a + 2 * k) * (a + 1.0 + 2 * k))):
            d = 1.0 / fix(1.0 + aa * d)
            c = fix(1.0 + aa / c)
            h = h * d * c
    return h


def betainc(a, b, x):
    """Regularized incomplete beta I_x(a, b), float64 tensors broadcast
    (torch has none); the continued fraction on the side of (a+1)/(a+b+2)
    where it converges."""
    front = torch.exp(torch.lgamma(a + b) - torch.lgamma(a) - torch.lgamma(b)
                      + a * torch.log(x) + b * torch.log1p(-x))
    direct = x < (a + 1.0) / (a + b + 2.0)
    lo = front * _betacf(a, b, torch.where(direct, x, 0.5)) / a
    hi = 1.0 - front * _betacf(b, a, torch.where(direct, 0.5, 1.0 - x)) / b
    return torch.where(direct, lo, hi)


def _t_sf(t, df):
    """Student-t survival function via the regularized incomplete beta."""
    return 0.5 * betainc(df / 2.0, torch.full_like(df, 0.5),
                         df / (df + t * t))


def emma_REML_t(ys, xs, K, Z=None, X0=None, ngrids: int = 100,
                llim: float = -10.0, ulim: float = 10.0, n_bisect: int = 60,
                *, device="cuda") -> dict:
    """emma.REML.t: per-variant REML Wald t-test (emma.R:1013-1274).

    stat = beta / sqrt(iXX[q,q] vg); p = 2 P(T_{n-q} > |stat|)
    (emma.R:1263). Monomorphic variants get p = 1. A dict of (m, g)
    float64 tensors on `device`: ps, stats, vgs, ves, REMLs, dfs. NaNs as
    in emma_ML_LRT."""
    q1 = (1 if X0 is None else np.shape(X0)[1]) + 1
    (stat, vg, ve, reml), sizes, xs = _run_tests(
        _reml_t_rot, ys, xs, K, Z, X0, llim, ulim, ngrids, n_bisect, device)
    dfs = sizes - q1
    mono = _monomorphic(xs)
    nan = torch.tensor(math.nan, dtype=F64, device=xs.device)
    return {"ps": torch.where(mono, 1.0, 2.0 * _t_sf(stat.abs(), dfs)),
            "stats": torch.where(mono, nan, stat),
            "vgs": torch.where(mono, nan, vg),
            "ves": torch.where(mono, nan, ve),
            "REMLs": torch.where(mono, nan, reml),
            "dfs": dfs}


def mle_noX(y, K, Z=None, llim: float = -10.0, ulim: float = 10.0,
            ngrids: int = 100, n_bisect: int = 60, *,
            device="cuda") -> REMLEResult:
    """emma.MLE.noX (emma.R:291-390): full-ML variance components with NO
    fixed effects: (xi, U) = eigh(K) and etas = U'y directly."""
    dev = require_device(device)
    y, K = as_f64(y, dev), _k_eff(K, Z, dev)
    n = y.shape[0]
    xi, U = torch.linalg.eigh(K)
    etasq = (U.T @ y) ** 2

    def ll_fn(logdelta):
        delta = torch.exp(logdelta)[..., None]
        w = 1.0 / (xi + delta)
        yPy = (etasq * w).sum(-1)
        ll = 0.5 * (n * (math.log(n / (2 * math.pi)) - 1.0 - torch.log(yPy))
                    - torch.log(xi + delta).sum(-1))
        return ll, 0.5 * delta[..., 0] * (
            n * (etasq * w * w).sum(-1) / yPy - w.sum(-1))

    best, ll = _grid_opt_rot(ll_fn, (), y, llim, ulim, 1e-10, ngrids,
                             n_bisect)
    delta = torch.exp(best)
    vg = torch.sum(etasq / (xi + delta)) / n
    return REMLEResult(reml_ll=ll, delta=delta, vg=vg, ve=vg * delta)


def emma_test(ys, xs, K, Z=None, X0=None, use_MLE: bool = False,
              use_LRT: bool = False, ngrids: int = 100,
              llim: float = -10.0, ulim: float = 10.0, *,
              device="cuda") -> dict:
    """emma.test (emma.R:743-1010): the REML Wald t by default, the ML
    likelihood ratio when use_MLE or use_LRT. Only the single-df,
    no-extra-covariate configuration, as in the JAX package (the
    reference's generalized branches cannot run as shipped); Z via
    K_eff = Z K Z'."""
    fn = emma_ML_LRT if use_MLE or use_LRT else emma_REML_t
    return fn(ys, xs, K, Z=Z, X0=X0, ngrids=ngrids, llim=llim, ulim=ulim,
              device=device)
