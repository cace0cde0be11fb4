"""Streaming top-k over the k-mer axis (port of kmersgwas_tpu/ops/topk.py).

Tie semantics match the reference heap: an incumbent is only displaced by a
STRICTLY greater score, and on equal scores the earlier (lower-row) entry
wins (best_associations_heap.cpp:50). The JAX package gets this from the
stability of `lax.top_k`; here every selection is a STABLE descending
`torch.sort` (or an explicit (value desc, index asc) two-key order).
`torch.topk` is never used where ties matter: it does not say which of
several equal values it keeps.

Row indices can exceed int32, so they ride as two int32 planes (lo 30
bits / hi bits), as in the JAX package (checkpoints are interchangeable).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

_ROW_SPLIT = 1 << 30


class TopKState(NamedTuple):
    scores: torch.Tensor   # (P, K) f32, descending
    row_lo: torch.Tensor   # (P, K) int32
    row_hi: torch.Tensor   # (P, K) int32


def encode_rows(rows: np.ndarray):
    """Split NON-NEGATIVE row ids into (lo, hi) int32 halves (copy of
    kmersgwas_tpu.ops.topk.encode_rows)."""
    rows = np.asarray(rows, dtype=np.int64)
    lo = np.bitwise_and(rows, _ROW_SPLIT - 1).astype(np.int32)
    hi = np.right_shift(rows, _ROW_SPLIT.bit_length() - 1).astype(np.int32)
    return lo, hi


def decode_rows(row_lo: np.ndarray, row_hi: np.ndarray) -> np.ndarray:
    """Copy of kmersgwas_tpu.ops.topk.decode_rows."""
    return row_hi.astype(np.int64) * _ROW_SPLIT + row_lo.astype(np.int64)


def top_k(x: torch.Tensor, k: int):
    """Stable top-k over the last axis: (values, indices), ties resolved to
    the lowest index — the semantics of `lax.top_k`."""
    v, i = torch.sort(x, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def sort_desc_index_asc(v: torch.Tensor, idx: torch.Tensor):
    """Reorder (v, idx) pairs along the last axis by (v desc, idx asc): the
    two-key `lax.sort((-v, idx), num_keys=2)` of the reference."""
    idx_s, o = torch.sort(idx, dim=-1, stable=True)
    v2, o2 = torch.sort(v.gather(-1, o), dim=-1, descending=True, stable=True)
    return v2, idx_s.gather(-1, o2)


def blocked_top_k(sc: torch.Tensor, k: int, block: int = 16):
    """Exact stable top-k over the last axis via block-max pre-reduction
    (port of kmersgwas_tpu.ops.topk.blocked_top_k; same exactness argument:
    the k highest-max blocks, earliest first on ties, hold exactly the
    elements a flat stable top-k keeps).

    sc: (P, R). Returns (values (P,k), indices (P,k))."""
    p, r = sc.shape
    k = min(k, r)
    if (r + block - 1) // block <= k:
        return top_k(sc, k)
    if r % block:
        pad = block - r % block
        sc = torch.nn.functional.pad(sc, (0, pad), value=float("-inf"))
        r += pad
    nb = r // block
    blocks = sc.view(p, nb, block)
    bmax = blocks.amax(dim=-1)                            # (P, nb)
    _, bi = blocked_top_k(bmax, k, block)                 # (P, k) block ids
    bi, _ = torch.sort(bi, dim=-1)                        # ascending rows
    cand = blocks.gather(1, bi[:, :, None].expand(p, k, block))
    cand = cand.reshape(p, k * block)
    cand_idx = (bi[:, :, None] * block
                + torch.arange(block, device=sc.device)).reshape(p, k * block)
    v, j = top_k(cand, k)
    return v, cand_idx.gather(1, j)


def top_k_from_bmax(sc: torch.Tensor, bmax: torch.Tensor, k: int):
    """Top-k given precomputed block maxima (ops/score.score_batch_t_bmax):
    extraction gathers only k blocks per column instead of re-reading the
    (P, R) scores. The contract of the reference's strided_top_k_from_bmax
    (kmersgwas_tpu/ops/topk.py:94-147), with CONTIGUOUS blocks: block b
    holds lanes [b*block, (b+1)*block) — the strided layout there exists
    only for Mosaic.

    Returns (values, indices, exact): `exact` ((P,) bool, on the device)
    is True for a column iff its k-th kept value STRICTLY exceeds
    everything excluded (the (k+1)-th gathered candidate and the (k+1)-th
    block max); the kept pairs come back in (value desc, index asc) order.
    Callers must take an exact path for the columns where `exact` is False.

    sc: (P, R), bmax: (P, R/block)."""
    p, r = sc.shape
    nbt = bmax.shape[1]
    assert r % nbt == 0
    block = r // nbt
    k = min(k, r)
    if nbt <= k + 1 or k + 1 >= r:
        v, i = top_k(sc, k)
        return v, i, torch.ones(p, dtype=torch.bool, device=sc.device)
    _, bi = blocked_top_k(bmax, k + 1, block=16)          # (P, k+1) blocks
    bsel, bnext = bi[:, :k], bi[:, k]
    m_next = bmax.gather(1, bnext[:, None])[:, 0]         # (P,)
    cand = sc.view(p, nbt, block).gather(
        1, bsel[:, :, None].expand(p, k, block)).reshape(p, k * block)
    cand_idx = (bsel[:, :, None] * block
                + torch.arange(block, device=sc.device)).reshape(p, k * block)
    vv, jj = top_k(cand, k + 1)                           # +1: boundary probe
    v, j = vv[:, :k], jj[:, :k]
    idx = cand_idx.gather(1, j)
    exact = (v[:, -1] > vv[:, k]) & (v[:, -1] > m_next)
    v, idx = sort_desc_index_asc(v, idx)
    return v, idx, exact


def finalize(state: TopKState):
    """-> per phenotype (scores (K,) f64, rows (K,) int64) on the host with
    -inf slots dropped (port of kmersgwas_tpu.ops.topk.finalize)."""
    scores = state.scores.cpu().numpy().astype(np.float64)
    rows = decode_rows(state.row_lo.cpu().numpy(), state.row_hi.cpu().numpy())
    out = []
    for p in range(scores.shape[0]):
        valid = np.isfinite(scores[p])
        out.append((scores[p][valid], rows[p][valid]))
    return out
