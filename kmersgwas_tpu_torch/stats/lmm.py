"""Exact mixed-model association: ML likelihood-ratio test per variant
(port of kmersgwas_tpu/stats/lmm.py; GEMMA 0.96 `-lmm 2`, which the
reference runs on the top-k candidates, kmers_gwas.py:162-165).

Per variant x:  y = W a + x b + u + e,  u ~ N(0, vg K),  e ~ N(0, ve I).
With K = U D U' and everything rotated by U', the ML profile likelihood at
lambda = vg/ve is

    l(lambda) = n/2 log(n/(2 pi)) - n/2 - 1/2 sum log(v_i) - n/2 log RSS
    v_i = lambda d_i + 1,  RSS = min_b sum (y_i - X_i b)^2 / v_i

maximized over log10 lambda in [-5, 5] by a grid and a 40-step
golden-section refine; the null model (W only) once per column;
p_lrt = chi2_sf(2 (l1 - l0), df=1).

The intercept-only path (the pipeline's) is batched over columns and
candidates. On the grid, w_g = 1/(10^g d + 1) is the same for every
variant, so the three sums that depend on the variant are products of the
(C*M, n) rotated variants by (n, G) over all grid points at once; the
refine has a lambda per variant, so each of its evaluations is one
elementwise pass over the (C, M, n) stack and a few reductions. Sums run
in another order than the JAX package's, so results agree to a tolerance,
not bit for bit.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from ..ops.bitplanes import as_planes, unpack_bits
from ..utils import require_device

LOG_LMIN, LOG_LMAX = -5.0, 5.0   # log10 lambda bounds, as GEMMA's defaults
_GOLD = 0.5 * (3.0 - 5.0 ** 0.5)
# bound on the elements of one (columns, candidates, n) block of the
# rotated stack: the refine keeps about six such tensors alive
_BLOCK_ELEMS = 1 << 27


class LMMResult(NamedTuple):
    log10_lambda: torch.Tensor   # per-variant ML lambda (log10)
    logl_alt: torch.Tensor
    beta: torch.Tensor
    p_lrt: torch.Tensor


def _ll(n, sum_log_v, rss):
    rss = torch.clamp_min(rss, 1e-300)
    return 0.5 * (n * (math.log(n / (2 * math.pi)) - 1.0 - torch.log(rss))
                  - sum_log_v)


def _weights(log10_lam, d):
    """(w = 1/v, sum log v) with v = 10^log10_lam d + 1, one row of n per
    entry of log10_lam."""
    v = torch.pow(10.0, log10_lam)[..., None] * d + 1.0
    return 1.0 / v, torch.log(v).sum(-1)


def _ll2_from_sums(n, sum_log_v, a, b, dd, r1, r2, yy):
    """Closed-form c == 2 profile LL (intercept + variant) from its six
    weighted sums -> (ll, beta of the variant). The JAX formula, det near
    0 included (kmersgwas_tpu/stats/lmm.py:78-81)."""
    det = a * dd - b * b
    beta1 = (dd * r1 - b * r2) / det
    beta2 = (a * r2 - b * r1) / det
    return _ll(n, sum_log_v, yy - (r1 * beta1 + r2 * beta2)), beta2


def _profile_ll(log10_lam, d, Xt, yt):
    """ML profile LL at log10_lam (any batch shape B) with covariates Xt
    (B + (n, c) or (n, c); last column = the variant) and phenotype yt
    ((n,) rotated) -> (ll B, beta B + (c,))."""
    n = yt.shape[-1]
    w, slv = _weights(log10_lam, d)
    Xw = Xt * w[..., None]
    G = Xt.transpose(-1, -2) @ Xw                    # (B, c, c)
    r = (Xw * yt[..., None]).sum(-2)                 # (B, c)
    beta = torch.linalg.solve(G, r)
    rss = (w * yt * yt).sum(-1) - (r * beta).sum(-1)
    return _ll(n, slv, rss), beta


def _profile_ll2(log10_lam, d, w1t, xt, yt):
    """Closed-form c == 2 (intercept w1t + variant xt, both rotated) at a
    lambda per variant: log10_lam (C, M), xt (C, M, n), yt (C, n) ->
    (ll, beta of the variant), each (C, M). One elementwise pass over the
    stack; the sums that need only w are products with w1t and yt."""
    n = yt.shape[-1]
    w, slv = _weights(log10_lam, d)                  # (C, M, n)
    fw = torch.stack([w1t.expand_as(yt) * w1t, w1t * yt, yt * yt], -1)
    a, r1, yy = (w @ fw).unbind(-1)                  # (C, n, 3) per column
    wx = w * xt
    b, r2 = (wx @ torch.stack([w1t.expand_as(yt), yt], -1)).unbind(-1)
    dd = (wx * xt).sum(-1)
    return _ll2_from_sums(n, slv, a, b, dd, r1, r2, yy)


def _grid_ll2(grid, d, w1t, xt, yt):
    """_profile_ll2 at every grid point for every variant -> (C, M, G):
    w_g is shared by all variants, so the variant's sums are (C*M, n) x
    (n, G) products; no (C, M, n, G) tensor is formed."""
    n = yt.shape[-1]
    w, slv = _weights(grid, d)                       # (G, n), (G,)
    a = w @ (w1t * w1t)                              # (G,)
    r1 = (w1t * yt) @ w.T                            # (C, G)
    yy = (yt * yt) @ w.T
    b = xt @ (w * w1t).T                             # (C, M, G)
    dd = (xt * xt) @ w.T
    r2 = (xt * yt[:, None, :]) @ w.T
    return _ll2_from_sums(n, slv, a, b, dd, r1[:, None], r2,
                          yy[:, None])[0]


def _profile_ll1(log10_lam, d, w1t, yt):
    """Closed-form c == 1 (intercept-only null model): log10_lam (C, K),
    yt (C, n) -> ll (C, K)."""
    n = yt.shape[-1]
    w, slv = _weights(log10_lam, d)                  # (C, K, n)
    a = w @ (w1t * w1t)
    r1, yy = (w @ torch.stack([w1t * yt, yt * yt], -1)).unbind(-1)
    return _ll(n, slv, yy - r1 * r1 / a)


def _optimize(ll_fn, grid_lls, grid, n_refine: int):
    """Grid + golden-section maximizer. grid_lls (..., G) is the profile
    LL on `grid`; ll_fn(log10_lam (...)) -> (ll, beta). Keeps the JAX
    package's rule: the grid's first maximum, its two neighbours as the
    bracket, n_refine steps with the strict f1 < f2 update."""
    i = torch.argmax(grid_lls, -1)                   # first maximum
    g = grid.shape[0]
    lo = grid[torch.clamp_min(i - 1, 0)]
    hi = grid[torch.clamp_max(i + 1, g - 1)]
    for _ in range(n_refine):
        m1 = lo + _GOLD * (hi - lo)
        m2 = hi - _GOLD * (hi - lo)
        up = ll_fn(m1)[0] < ll_fn(m2)[0]
        lo, hi = torch.where(up, m1, lo), torch.where(up, hi, m2)
    best = 0.5 * (lo + hi)
    ll, beta = ll_fn(best)
    return best, ll, beta


def chi2_sf_df1(x):
    """Survival function of chi-squared with 1 df: erfc(sqrt(x/2))."""
    return torch.special.erfc(torch.sqrt(torch.clamp_min(x, 0.0) / 2.0))


def _null_ll(d, w1t, yt, grid, n_refine):
    """The intercept-only model's ML LL per column, yt (C, n) -> (C,)."""
    grid_lls = _profile_ll1(grid.expand(yt.shape[0], -1), d, w1t, yt)
    return _optimize(
        lambda g: (_profile_ll1(g[:, None], d, w1t, yt)[:, 0], None),
        grid_lls, grid, n_refine)[1]


def _scan_intercept(genos, m, ys, d, U, n_grid, n_refine):
    """Intercept-only ML-LRT over m candidates a column. genos(s, e) ->
    the (C, e - s, n) variants s:e of every column in the working dtype;
    ys (C, n). The candidates go in blocks of at most _BLOCK_ELEMS stack
    elements."""
    c, n = ys.shape
    grid = torch.linspace(LOG_LMIN, LOG_LMAX, n_grid, dtype=ys.dtype,
                          device=ys.device)
    yt = ys @ U                                      # (U' y) per column
    w1t = U.sum(0)                                   # U' 1
    ll_null = _null_ll(d, w1t, yt, grid, n_refine)
    step = max(1, _BLOCK_ELEMS // max(1, c * n))
    parts = []
    for s in range(0, m, step):
        xt = genos(s, min(m, s + step)) @ U          # (U' x) per variant
        lg, ll, beta = _optimize(
            lambda g: _profile_ll2(g, d, w1t, xt, yt),
            _grid_ll2(grid, d, w1t, xt, yt), grid, n_refine)
        parts.append((lg, ll, beta,
                      chi2_sf_df1(2.0 * (ll - ll_null[:, None]))))
        del xt
    if not parts:
        e = ys.new_empty((c, 0))
        return LMMResult(e, e, e, e)
    return LMMResult(*(torch.cat(f, 1) for f in zip(*parts)))


def _tensors(dev, dtype, *xs):
    return [torch.as_tensor(x, dtype=dtype, device=dev) for x in xs]


def lmm_scan(genotypes, y, K_eigvals, K_eigvecs, covariates=None,
             n_grid: int = 64, n_refine: int = 40, *,
             device="cuda") -> LMMResult:
    """Exact ML-LRT over variants, in float64 on `device`.

    genotypes: (M, n) per-variant genotype rows (0/1 presence for k-mers).
    y: (n,) phenotype. K_eigvals (n,), K_eigvecs (n, n) from eigh(K).
    covariates: (n, c) fixed effects, defaults to the intercept."""
    dev = require_device(device)
    dtype = torch.float64
    g, y, d, U = _tensors(dev, dtype, genotypes, y, K_eigvals, K_eigvecs)
    if covariates is None:
        r = _scan_intercept(lambda s, e: g[None, s:e], g.shape[0], y[None],
                            d, U, n_grid, n_refine)
        return LMMResult(*(f[0] for f in r))

    Wt = U.T @ torch.as_tensor(covariates, dtype=dtype, device=dev)
    yt = U.T @ y
    grid = torch.linspace(LOG_LMIN, LOG_LMAX, n_grid, dtype=dtype,
                          device=dev)
    # null model, once
    ll_null = _optimize(lambda lg: _profile_ll(lg, d, Wt, yt),
                        _profile_ll(grid, d, Wt, yt)[0], grid, n_refine)[1]
    xt = g @ U                                       # (M, n)
    Xt = torch.cat([Wt.expand(xt.shape[0], -1, -1), xt[..., None]], -1)

    def alt(lg):
        return _profile_ll(lg, d, Xt, yt)
    grid_lls = torch.stack(
        [alt(gv.expand(xt.shape[0]))[0] for gv in grid], -1)
    lg, ll, beta = _optimize(alt, grid_lls, grid, n_refine)
    return LMMResult(log10_lambda=lg, logl_alt=ll, beta=beta[..., -1],
                     p_lrt=chi2_sf_df1(2.0 * (ll - ll_null)))


def lmm_scan_columns(genotypes, ys, K_eigvals, K_eigvecs,
                     n_grid: int = 64, n_refine: int = 40, *,
                     device="cuda") -> LMMResult:
    """ML-LRT over variants for several phenotype columns at once:
    genotypes (P, M, n) per-column candidates, ys (P, n). The reference
    farms one GEMMA process per column (functions.py:61-66); here the
    column axis is one more batch axis. Fields are (P, M), float64."""
    dev = require_device(device)
    g, ys, d, U = _tensors(dev, torch.float64, genotypes, ys, K_eigvals,
                           K_eigvecs)
    return _scan_intercept(lambda s, e: g[:, s:e], g.shape[1], ys, d, U,
                           n_grid, n_refine)


def lmm_scan_columns_packed(packed_genos, ys, K_eigvals, K_eigvecs, *,
                            n: int, n_grid: int = 64, n_refine: int = 40,
                            device="cuda",
                            dtype=torch.float32) -> LMMResult:
    """lmm_scan_columns fed packed presence bits, unpacked on `device`.

    packed_genos (P, M, W32) bit-planes (LSB-first lanes, >= n bits):
    uint32 numpy words or their int32 tensor view; ys (P, n). The host
    ships ~n/8 bytes per genotype instead of 8. float32 (the default) is
    the pipeline's `device32` backend, float64 its `host64`. float32's LRT
    is off the float64 one by up to ~2e-3 at n=1008 (chip_smoke.py phase
    18): log10 p by ~5e-4 where p is small, and p by far more near p = 1,
    where p = erfc(sqrt(LRT / 2)) is steep in the LRT."""
    dev = require_device(device)
    planes = as_planes(packed_genos) \
        if isinstance(packed_genos, np.ndarray) else packed_genos
    planes = planes.to(dev)
    ys, d, U = _tensors(dev, dtype, ys, K_eigvals, K_eigvecs)
    return _scan_intercept(
        lambda s, e: unpack_bits(planes[:, s:e], dtype)[..., :n],
        planes.shape[1], ys, d, U, n_grid, n_refine)


# copy of kmersgwas_tpu.stats.lmm.grammar_gamma_score
def grammar_gamma_score(genotypes, y_transformed, n_used, min_count, *,
                        device="cuda"):
    """GRAMMAR-Gamma approximate score (the dense float32 form; the scan
    computes it on packed bits in its kernels)."""
    dev = require_device(device)
    g, y = _tensors(dev, torch.float32, genotypes, y_transformed)
    n1 = g.sum(1)
    r = n_used * (g @ y) - n1 * y.sum()
    denom = n_used * n1 - n1 * n1
    ok = (n1 >= min_count) & ((n_used - n1) >= min_count) & (denom > 0)
    return torch.where(ok, r * r / denom, torch.zeros_like(r))
