"""Partitioning of the k-mer axis across processes and the exact merge of
their top-k states (port of the multi-process half of kmersgwas_tpu/
parallel/sharding.py).

Each process owns one device and streams one contiguous range of the
k-mer space (`host_range_of_kmer_space`); its top-k state never leaves it
until finalize, where every process gathers every state over
`torch.distributed` (gloo, CPU tensors) and runs the same exact merge.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops import topk as topk_ops


def world() -> tuple[int, int]:
    """(process count, this process's rank) of the default process group;
    (1, 0) when torch.distributed is not initialised."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


def all_gather_np(a: np.ndarray) -> np.ndarray:
    """Every process's `a` (same shape and dtype everywhere) stacked in rank
    order -> (n_proc, *a.shape), over the default process group."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def broadcast_np(a: np.ndarray, src: int = 0) -> np.ndarray:
    """Process `src`'s `a` on every process (each passes an array of the
    same shape and dtype), over the default process group. The payload
    travels as its raw bytes viewed as int64 words where the size allows
    (uint8 otherwise), so float64 values arrive bit for bit, NaN payloads
    and signed zeros included."""
    a = np.ascontiguousarray(a)
    raw = a.reshape(-1).view(np.uint8)
    wire = raw.view(np.int64) if raw.size % 8 == 0 else raw
    t = torch.from_numpy(wire.copy())
    dist.broadcast(t, src=src)
    return t.numpy().view(np.uint8).view(a.dtype).reshape(a.shape)


# copy of kmersgwas_tpu.parallel.sharding.host_range_of_kmer_space
def host_range_of_kmer_space(host_id: int, n_hosts: int, kmer_len: int):
    """Contiguous uint62 k-mer range owned by `host_id`, cut at the
    reference's slice boundaries so per-host table shards can be built
    independently and byte-identically."""
    from ..core.codec import step_bounds
    bounds = step_bounds(n_hosts, kmer_len)
    lo = 0 if host_id == 0 else int(bounds[host_id - 1])
    hi = int(bounds[host_id])
    return lo, hi


# copy of kmersgwas_tpu.parallel.sharding._merge_candidates
def _merge_candidates(all_v, all_lo, all_hi, k: int) -> list:
    """(P, D, K+C) candidate planes -> per-phenotype exact top-k under the
    total order (-score, row asc) — the reference heap's effective order
    (strictly-greater displacement + earliest-row ties,
    best_associations_heap.cpp:43-59)."""
    p = all_v.shape[0]
    v_flat = all_v.reshape(p, -1).astype(np.float64)
    rows = topk_ops.decode_rows(all_lo.reshape(p, -1), all_hi.reshape(p, -1))
    out = []
    for j in range(p):
        finite = np.isfinite(v_flat[j])
        v, r = v_flat[j][finite], rows[j][finite]
        order = np.lexsort((r, -v))[:k]
        out.append((v[order], r[order]))
    return out


def finalize_distributed(state) -> list:
    """Every process's BufferedTopKState -> the exact global per-phenotype
    top-k, the same on every process (kmersgwas_tpu.parallel.sharding.
    finalize_sharded_buffered). Each process's carried top-k and candidate
    buffer, (P, K+C), are gathered over the default process group (the one
    collective of the scan's data) and merged under (-score, row asc).
    Returns per phenotype (scores f64 desc, rows int64), -inf dropped.
    Every process must call this."""
    k = state.scores.shape[1]
    parts = [torch.cat([a, b], dim=1).cpu().numpy() for a, b in (
        (state.scores, state.buf_v), (state.row_lo, state.buf_lo),
        (state.row_hi, state.buf_hi))]
    n_proc, _ = world()
    parts = [all_gather_np(x) if n_proc > 1 else x[None] for x in parts]
    return _merge_candidates(*(x.transpose(1, 0, 2) for x in parts), k)
