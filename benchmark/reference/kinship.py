"""The EMMA kinship of voichek/kmersGWAS: for every k-mer row g that passes
the filter, K[i][j] += 1 when g_i == g_j; then K / (rows used), diagonal 1
(src/kmers_multiple_databases.cpp:418-438, emma_kinship_kmers.cpp:95-102).

The match counts come from an exact integer Gram of the rows as +-1:
(A^T A)[i, j] = matches - mismatches, so matches = (rows + A^T A) / 2.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def min_count(n_used: int, maf: float) -> int:
    """emma_kinship_kmers' filter: ceil(maf N) present and absent."""
    return math.ceil(n_used * maf)


def gram_pm1(planes: torch.Tensor) -> torch.Tensor:
    """A^T A, (32 W32, 32 W32) int64, of (R, W32) int32 rows read as +-1
    (R <= 2^24).

    The words go sample-major (W32, R), and each of a word's 32 bits
    becomes a row of +-1, so A^T is (32 W32, R) in sample order. On the
    card it is bfloat16 and the product torch.mm with float32 out: every
    +-1 product is exact, and float32 sums of at most 2^24 of them are exact
    integers. On the CPU an int32 matmul."""
    r, w32 = planes.shape
    if r > 1 << 24:
        raise ValueError(f"{r} rows: float32 sums are exact to 2^24")
    dev = planes.device
    bit = torch.tensor([1 << b for b in range(32)], dtype=torch.int64,
                       device=dev).to(torch.int32)
    on = (planes.T.contiguous()[:, None, :] & bit[None, :, None]) != 0
    if planes.is_cuda:
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
        one = torch.ones((), dtype=torch.bfloat16, device=dev)
        at = torch.where(on, one, -one).reshape(-1, r)
        return torch.mm(at, at.t(), out_dtype=torch.float32).to(torch.int64)
    at = torch.where(on, 1, -1).to(torch.int32).reshape(-1, r)
    return (at @ at.T).to(torch.int64)


def normalize(total: np.ndarray, n_rows: int, dtype=np.float64):
    """int64 sum of A^T A over the N used samples -> the kinship matrix in
    `dtype` (float64 is the configuration's; float32 is the control's):
    the match count (rows + total) / 2 over rows, diagonal 1."""
    if n_rows <= 0:
        raise ValueError("no rows")
    matches = (total + n_rows) // 2
    k = matches.astype(dtype) / dtype(n_rows)
    np.fill_diagonal(k, 1.0)
    return k.astype(np.float64)
