"""Scan state carried between the JAX package and the port.

The system has no weights; what carries across is the top-k scan state.
The JAX package's `TopKState` and `BufferedTopKState` are NamedTuples of
arrays: pass their fields as numpy arrays (e.g. `{k: np.asarray(v) for k,
v in state._asdict().items()}`) and get the port's state on `device`, or
take a port state back to numpy fields of the same names.

The multi-process scan (kmersgwas_tpu/parallel/multihost.py) keeps each
process's state with a leading local-device axis, `(D, P, K)`, `(D, P, C)`,
`(D,)` and `(D, P)`; its checkpoints hold those blocks. A port process owns
one device, so its blocks have D = 1 (`distributed_state_*`).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.scanstep import STATE_FIELDS, BufferedTopKState, settle
from .ops.topk import TopKState


def _t(a, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(device)


def topk_state_from_numpy(f, device) -> TopKState:
    """Mapping with scores (P,K) f32, row_lo/row_hi (P,K) int32 ->
    TopKState on `device`."""
    return TopKState(scores=_t(f["scores"], np.float32, device),
                     row_lo=_t(f["row_lo"], np.int32, device),
                     row_hi=_t(f["row_hi"], np.int32, device))


def buffered_state_from_numpy(f, device) -> BufferedTopKState:
    """Mapping with the fields of kmersgwas_tpu.ops.scanstep.
    BufferedTopKState -> the port's BufferedTopKState on `device`."""
    return BufferedTopKState(
        scores=_t(f["scores"], np.float32, device),
        row_lo=_t(f["row_lo"], np.int32, device),
        row_hi=_t(f["row_hi"], np.int32, device),
        buf_v=_t(f["buf_v"], np.float32, device),
        buf_lo=_t(f["buf_lo"], np.int32, device),
        buf_hi=_t(f["buf_hi"], np.int32, device),
        buf_n=int(f["buf_n"]),
        thresh=_t(f["thresh"], np.float32, device))


def to_numpy(state) -> dict:
    """A port TopKState or BufferedTopKState (settled first) -> {field:
    numpy array}."""
    items = ([(name, getattr(settle(state), name)) for name in STATE_FIELDS]
             if isinstance(state, BufferedTopKState)
             else state._asdict().items())
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.int32(v)) for k, v in items}


def distributed_state_from_numpy(blocks, device) -> BufferedTopKState:
    """One process's BufferedTopKState blocks with a leading local-device
    axis of length 1 (kmersgwas_tpu.parallel.multihost._local_state_blocks)
    -> the port's BufferedTopKState on `device`."""
    d = np.shape(blocks["scores"])[0]
    if d != 1:
        raise ValueError(f"the blocks hold the states of {d} devices; a "
                         "process of the port owns one")
    return buffered_state_from_numpy(
        {name: np.asarray(blocks[name])[0] for name in STATE_FIELDS},
        device)


def distributed_state_to_numpy(state: BufferedTopKState) -> dict:
    """The port's BufferedTopKState -> {field: numpy block} with a leading
    local-device axis of length 1, as the JAX package's multi-process
    checkpoints hold them."""
    return {k: v[None] for k, v in to_numpy(state).items()}
