"""Checkpoint/resume of the streaming scan (port of the scan half of
kmersgwas_tpu/pipeline/checkpoint.py).

The npz fields are the JAX package's (`scores`, `row_lo`, `row_hi`,
`next_row`, `n_tested`, `stream`, `meta_keys`, `meta_vals`), so a
checkpoint written by either package resumes in the other.
"""
from __future__ import annotations

import os

import numpy as np

from ..ops import topk as topk_ops


def _atomic_savez(path: str, **arrays) -> None:
    """Copy of kmersgwas_tpu.pipeline.checkpoint._atomic_savez."""
    path = str(path)
    if not path.endswith(".npz"):
        path += ".npz"
    tmp = path + ".tmp.npz"
    np.savez(tmp, **arrays)
    os.replace(tmp, path)


def _norm(path: str) -> str:
    """Copy of kmersgwas_tpu.pipeline.checkpoint._norm."""
    path = str(path)
    return path if path.endswith(".npz") else path + ".npz"


def _host(a) -> np.ndarray:
    return a.cpu().numpy() if hasattr(a, "cpu") else np.asarray(a)


def save_scan_state(path: str, state: topk_ops.TopKState, next_row: int,
                    n_tested: int, stream: str = "table",
                    meta: dict | None = None) -> None:
    """`stream` tags what `next_row` indexes: "table" = absolute .table row,
    "dtable" = row in the device-native cache. `meta`: config fingerprint;
    a resume under a conflicting fingerprint is refused."""
    _atomic_savez(path, scores=_host(state.scores),
                  row_lo=_host(state.row_lo), row_hi=_host(state.row_hi),
                  next_row=np.int64(next_row), n_tested=np.int64(n_tested),
                  stream=np.array(stream), **meta_arrays(meta))


def load_scan_state(path: str, meta: dict | None = None):
    """-> (TopKState of numpy arrays, next_row, n_tested, stream) or None if
    absent."""
    if not os.path.exists(_norm(path)):
        return None
    z = np.load(_norm(path))
    check_meta(z, meta, _norm(path))
    state = topk_ops.TopKState(scores=z["scores"], row_lo=z["row_lo"],
                               row_hi=z["row_hi"])
    stream = str(z["stream"]) if "stream" in z.files else "table"
    return state, int(z["next_row"]), int(z["n_tested"]), stream


def meta_arrays(meta: dict | None) -> dict:
    """Copy of kmersgwas_tpu.pipeline.checkpoint.meta_arrays."""
    if not meta:
        return {}
    return {"meta_keys": np.array(sorted(meta), dtype="U32"),
            "meta_vals": np.array([int(meta[k]) for k in sorted(meta)],
                                  dtype=np.int64)}


def check_meta(z, meta: dict | None, path: str) -> None:
    """Raise if a checkpoint's stored fingerprint conflicts with `meta`, or
    if it carries none while `meta` is given (copy of
    kmersgwas_tpu.pipeline.checkpoint.check_meta)."""
    if not meta:
        return
    if "meta_keys" not in getattr(z, "files", ()):
        raise ValueError(
            f"checkpoint {path} carries no topology fingerprint but this "
            f"run requires one ({sorted(meta)}); refusing to resume — "
            f"delete the checkpoint files to restart clean")
    stored = dict(zip((str(k) for k in z["meta_keys"]),
                      (int(v) for v in z["meta_vals"])))
    bad = {k: (stored[k], int(v)) for k, v in meta.items()
           if k in stored and stored[k] != int(v)}
    if bad:
        detail = ", ".join(f"{k}: checkpoint={a} run={b}"
                           for k, (a, b) in bad.items())
        raise ValueError(
            f"checkpoint {path} was written under a different "
            f"topology/config ({detail}); refusing to resume — delete the "
            f"checkpoint files to restart clean")
