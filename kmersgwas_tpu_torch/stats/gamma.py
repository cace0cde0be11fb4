"""GRAMMAR-Gamma correction factor from genotype data (port of
kmersgwas_tpu/stats/gamma.py; update_gamma_precalculations + calc_gamma,
src/kmers_multiple_databases.cpp:390-416, 468-497): accumulate

    R = (1/M) * sum over k-mers of g g^T,
    g_i = (bit_i - Egm) / sqrt(n (Egm - Egm^2)),  Egm = N1 / n

over (by default) the first ~100k MAC-passing k-mers, then
gamma = sum_ij Vinv_ij R_ij. Each batch is one standardized float32 GEMM
on `device` (TF32 off), as the JAX package accumulates in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.table import KmersTableReader
from ..ops.bitplanes import as_planes, unpack_bits
from ..utils import require_device


def gamma_accumulate(acc, packed, popcnt, n_used: int) -> torch.Tensor:
    """acc (N_pad, N_pad) float32 += A^T A of the standardized genotypes
    of int32 planes `packed` (R, W32) with popcounts (R,)."""
    if acc.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    g = unpack_bits(packed, torch.float32)           # (R, N_pad)
    mu = (popcnt / n_used)[:, None]
    a = (g - mu) * torch.rsqrt(n_used * (mu - mu * mu))
    # the padding columns would be -mu*denom: zero them
    a[:, n_used:] = 0.0
    return acc + a.T @ a


def calc_gamma(table_base: str, inv_cov: np.ndarray, *, min_count: int,
               max_variants: int = 100_000, batch_size: int = 10_000,
               names_to_use=None, device="cuda") -> float:
    """gamma = <Vinv, R> over up to max_variants MAC-passing k-mers."""
    dev = require_device(device)
    reader = KmersTableReader(table_base, names_to_use=names_to_use)
    n = reader.n_used
    if inv_cov.shape != (n, n):
        raise ValueError("inverse covariance shape mismatch")
    acc = torch.zeros((reader.w32 * 32, reader.w32 * 32),
                      dtype=torch.float32, device=dev)
    m = 0
    for batch in reader.iter_batches(batch_size, min_count):
        acc = gamma_accumulate(acc, as_planes(batch.packed).to(dev),
                               torch.as_tensor(batch.popcnt, device=dev), n)
        m += batch.n_rows
        if m >= max_variants:
            break
    if m == 0:
        raise ValueError("no k-mers passed the MAC filter")
    R = acc.cpu().numpy().astype(np.float64)[:n, :n] / m
    return float(np.sum(inv_cov * R))
