"""Scaling the scan and kinship over devices and processes (port of
kmersgwas_tpu/parallel/sharding.py).

The k-mer axis (the table's rows) is the sharding axis; the samples axis
is replicated everywhere.

  * one process, several devices: a `Mesh` lists one device per shard
    (entries may repeat a device, so D shards can share one card or the
    CPU). A batch is cut into D contiguous row shards; each shard carries
    its OWN buffered top-k state and runs the single-device step on its
    device, with no exchange per step. The exact global top-k is merged
    on the host at finalize (selection under the total order (-score, row
    asc) is mergeable), so the result equals the single-device run's.
    Launches are queued shard after shard: they overlap on distinct cards
    and run one after another on a shared one. (Kinship over a mesh is
    ops/kinship.KinshipAccumulator(mesh=): one int32 partial per shard,
    summed into the host int64 total at flush.)
  * several processes: each owns one device and streams one contiguous
    range of the k-mer space (`host_range_of_kmer_space`); its top-k state
    never leaves it until finalize, where every process gathers every
    state over `torch.distributed` (gloo, CPU tensors) and runs the same
    exact merge (parallel/multihost.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

from ..ops import scanstep as ss
from ..ops import topk as topk_ops
from ..utils import require_device

AXIS = "kmers"


@dataclass(frozen=True)
class Mesh:
    """A one-axis ("kmers") device mesh: shard d runs on devices[d]."""
    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)

    def distinct(self) -> list:
        """The mesh's devices without repeats, in shard order."""
        return list(dict.fromkeys(self.devices))


def make_mesh(devices=None) -> Mesh:
    """A mesh over `devices` (torch.device or strings; repeats allowed, all
    of one kind), by default every visible card; raises when a card is
    asked for (or defaulted to) and none is visible."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh() needs a card "
                               "(torch.cuda.is_available() is False); pass "
                               "devices explicitly for a CPU mesh")
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = []
    for d in devices:
        d = require_device(d)
        devs.append(torch.device("cuda", 0) if d.type == "cuda"
                    and d.index is None else d)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) > 1:
        raise ValueError("a mesh's devices must all be of one kind, not "
                         f"{sorted({d.type for d in devs})}")
    return Mesh(tuple(devs))


def mesh_for(n_devices: int | None, device) -> Mesh | None:
    """The CLI's `--devices N`: N shards round-robin over the visible cards
    (cuda:{i % count}), or N cpu shards when `device` is the CPU; None for
    N <= 1 (the single-device path)."""
    if not n_devices or n_devices <= 1:
        return None
    dev = require_device(device)
    if dev.type == "cpu":
        return make_mesh(["cpu"] * n_devices)
    count = torch.cuda.device_count()
    return make_mesh([f"cuda:{i % count}" for i in range(n_devices)])


def home_device(mesh: Mesh | None, device) -> tuple:
    """(the device a driver stages its batches on, the mesh it runs):
    the mesh's first shard's device, which must be of the kind `device`
    names; without a mesh, a one-shard mesh over `device`."""
    dev = require_device(device)
    if mesh is None:
        mesh = make_mesh([dev])
    if mesh.devices[0].type != dev.type:
        raise ValueError(f"device {device!r} and a mesh over "
                         f"{mesh.devices[0].type} devices disagree")
    return mesh.devices[0], mesh


def _tensor(a) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype == np.uint32:                   # planes ride as int32 bits
        a = a.view(np.int32)
    if not a.flags.writeable or not a.flags.c_contiguous:
        a = np.array(a)
    return torch.from_numpy(a)


def shard_batch(mesh: Mesh, arrays, pad_value=0) -> list:
    """Cut each array (tensor or numpy; uint32 planes become int32) into
    mesh.size contiguous row shards: shard d holds rows [d*R/D, (d+1)*R/D)
    of the array padded at its end with `pad_value` to a multiple of D.
    -> one list of D tensors per array, shard d on mesh.devices[d]. A
    shard on the array's own device is a view (no copy); the padding, when
    needed, is one copy."""
    d = mesh.size
    out = []
    for a in arrays:
        t = _tensor(a)
        r = t.shape[0]
        rp = -(-r // d) * d
        if rp != r:
            t = torch.cat([t, t.new_full((rp - r, *t.shape[1:]), pad_value)])
        s = rp // d
        out.append([t[i * s:(i + 1) * s].to(dev)
                    for i, dev in enumerate(mesh.devices)])
    return out


def replicate(mesh: Mesh, *arrays) -> list:
    """Each array on every shard's device, placed once per distinct device
    (shards sharing a device share the tensor). -> one list of D tensors
    per array."""
    out = []
    for a in arrays:
        t = _tensor(a)
        placed = {dev: t.to(dev) for dev in mesh.distinct()}
        out.append([placed[dev] for dev in mesh.devices])
    return out


def _to(a, dtype, device) -> torch.Tensor:
    return _tensor(a).to(device=device, dtype=dtype).contiguous()


def init_sharded_buffered_state(mesh: Mesh, n_phenotypes: int, k: int,
                                buf_cap: int, seed_state=None) -> list:
    """One empty BufferedTopKState per shard, on its device. Each shard
    carries its own top-k over its rows; the states meet only at
    finalize_sharded_buffered.

    seed_state: an optional resumed TopKState (P, K) (tensors or numpy),
    put into shard 0 ONLY (the other shards start empty), so the final
    cross-shard merge stays exact without deduplication."""
    states = [ss.init_buffered_state(n_phenotypes, k, buf_cap, dev)
              for dev in mesh.devices]
    if seed_state is not None:
        st, dev = states[0], mesh.devices[0]
        st.scores = _to(seed_state.scores, torch.float32, dev)
        st.row_lo = _to(seed_state.row_lo, torch.int32, dev)
        st.row_hi = _to(seed_state.row_hi, torch.int32, dev)
        st.thresh = st.scores[:, -1].clone()
    return states


def build_sharded_scan_step_compact(mesh: Mesh, *, n_used: int,
                                    min_count: int, cand_k: int,
                                    tile_rows: int, cand_w: int | None = None,
                                    cand_c: int | None = None,
                                    cand_c2: int | None = None,
                                    cand_q: int | None = None,
                                    precision: str = "default",
                                    col_group: int = 128, block: int = 16,
                                    counts: dict | None = None):
    """The mesh's scan step: ops/scanstep.scan_step_compact on every shard
    -> step(states, packed, popcnt, row_lo, row_hi, yp, ysum) -> states.

    states: init_sharded_buffered_state's, updated in place one batch late
    as scan_step_compact updates one (ss.settle each state, or read them
    through finalize_sharded_buffered); packed, popcnt, row_lo, row_hi:
    shard_batch's lists; yp, ysum: replicate's. The keywords are
    scan_step_compact's, the same for every shard. Every shard's candidate
    kernel is queued before any shard's previous batch is applied, so
    shards on distinct cards overlap; then each shard appends or falls
    back on its own, with no exchange per step. counts: summed over
    shards."""
    def step(states, packed, popcnt, row_lo, row_hi, yp, ysum):
        prev = [ss.compact_enqueue(
            st, packed[d], popcnt[d], row_lo[d], row_hi[d], yp[d], ysum[d],
            n_used=n_used, min_count=min_count, cand_k=cand_k,
            tile_rows=tile_rows, cand_w=cand_w, cand_c=cand_c,
            cand_c2=cand_c2, cand_q=cand_q, precision=precision,
            col_group=col_group, block=block, counts=counts)
            for d, st in enumerate(states)]
        for st, pend in zip(states, prev):
            if pend is not None:
                ss.apply_pending(st, pend)
        return states
    return step


def _candidates(state) -> list:
    """A BufferedTopKState's carried top-k and buffer side by side (after
    its pending batch is applied): the (P, K + C) score, row_lo and row_hi
    planes, on the host."""
    ss.settle(state)
    return [torch.cat([a, b], dim=1).cpu().numpy() for a, b in (
        (state.scores, state.buf_v), (state.row_lo, state.buf_lo),
        (state.row_hi, state.buf_hi))]


def finalize_sharded_buffered(states) -> list:
    """One process's per-shard states -> the exact global per-phenotype
    top-k: every shard's carried top-k and buffer, merged under (-score,
    row asc). Returns per phenotype (scores f64 desc, rows int64), -inf
    dropped, as ops/topk.finalize does; one shard's state is flushed and
    finalized on its device. (The multi-process form of this gather is
    finalize_distributed.)"""
    if len(states) == 1:
        return topk_ops.finalize(ss.flush_buffered(states[0]))
    k = states[0].scores.shape[1]
    parts = zip(*(_candidates(st) for st in states))
    return _merge_candidates(*(np.stack(x, axis=1) for x in parts), k)


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
    n_proc, _ = world()
    parts = [all_gather_np(x) if n_proc > 1 else x[None]
             for x in _candidates(state)]
    return _merge_candidates(*(x.transpose(1, 0, 2) for x in parts), k)
