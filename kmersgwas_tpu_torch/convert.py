"""Scan state carried between the JAX package and the port.

The system has no weights; what carries across is the top-k scan state.
The JAX package's `TopKState` and `BufferedTopKState` are NamedTuples of
arrays: pass their fields as numpy arrays (e.g. `{k: np.asarray(v) for k,
v in state._asdict().items()}`) and get the port's state on `device`, or
take a port state back to numpy fields of the same names.
"""
from __future__ import annotations

from dataclasses import fields, is_dataclass

import numpy as np
import torch

from .ops.scanstep import BufferedTopKState
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
    """A port TopKState or BufferedTopKState -> {field: numpy array}."""
    items = ([(f.name, getattr(state, f.name)) for f in fields(state)]
             if is_dataclass(state) else state._asdict().items())
    return {k: (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.int32(v)) for k, v in items}
