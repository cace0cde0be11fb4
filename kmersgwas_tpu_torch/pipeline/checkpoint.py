"""Checkpoint/resume of the streaming scans and of the kinship accumulator
(port of kmersgwas_tpu/pipeline/checkpoint.py, and of the per-process
checkpoints of kmersgwas_tpu/parallel/multihost.run_distributed_scan).

The npz fields are the JAX package's, so a checkpoint written by either
package resumes in the other: `scores`, `row_lo`, `row_hi`, `next_row`,
`n_tested`, `stream`, `meta_keys`, `meta_vals` for the single-process
scan; the BufferedTopKState fields with a leading local-device axis plus
`next_row`, `n_tested`, `stream` (bytes) and the meta keys for one process
of the multi-process scan; `total`, `n_rows`, `next_row`, `stream` (bytes)
and the meta keys for kinship (single- or multi-process).
"""
from __future__ import annotations

import os

import numpy as np

from .. import convert
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


def save_distributed_state(path: str, state, next_row: int, n_tested: int,
                           stream: str, meta: dict) -> None:
    """One process's BufferedTopKState of the multi-process scan, with the
    position after its last batch and its tested count, stamped with the
    topology fingerprint `meta`."""
    _atomic_savez(path, **convert.distributed_state_to_numpy(state),
                  next_row=np.int64(next_row), n_tested=np.int64(n_tested),
                  stream=np.bytes_(stream.encode()), **meta_arrays(meta))


def load_distributed_state(path: str, stream: str, meta: dict, device):
    """-> (BufferedTopKState on `device`, next_row, n_tested), or None when
    the checkpoint is absent or indexes the other stream. Refuses (ValueError)
    a checkpoint whose fingerprint differs from `meta` or that holds the
    states of more than one device (a mesh of the JAX package): this process
    owns one device, and dropping or merging the other states would
    mis-resume silently."""
    path = _norm(path)
    if not os.path.exists(path):
        return None
    z = np.load(path)
    if bytes(z["stream"]).decode() != stream:
        return None
    check_meta(z, meta, path)
    d = z["scores"].shape[0]
    if d != 1:
        raise ValueError(
            f"checkpoint {path} holds the top-k states of {d} devices, and "
            f"this process owns one; refusing to resume — delete the "
            f"checkpoint files to restart clean")
    return (convert.distributed_state_from_numpy(z, device),
            int(z["next_row"]), int(z["n_tested"]))


def save_kinship_state(path: str, total: np.ndarray, n_rows: int,
                       next_row: int, stream: str = "table",
                       meta: dict | None = None) -> None:
    """Copy of kmersgwas_tpu.pipeline.checkpoint.save_kinship_state: the
    int64 host total, the rows accumulated, and the position after the last
    batch; `stream` tags whether next_row is a .table or a .dtable row, and
    `meta` is the config/topology fingerprint a resume must match."""
    _atomic_savez(path, total=total, n_rows=np.int64(n_rows),
                  next_row=np.int64(next_row),
                  stream=np.bytes_(stream.encode()), **meta_arrays(meta))


def load_kinship_state(path: str, stream: str = "table",
                       meta: dict | None = None):
    """-> (total int64, n_rows, next_row), or None when the checkpoint is
    absent or indexes the other stream (copy of kmersgwas_tpu.pipeline.
    checkpoint.load_kinship_state); refuses a conflicting fingerprint."""
    if not os.path.exists(_norm(path)):
        return None
    z = np.load(_norm(path))
    tag = bytes(z["stream"]).decode() if "stream" in z else "table"
    if tag != stream:
        return None               # checkpoint from the other stream route
    check_meta(z, meta, _norm(path))
    return z["total"], int(z["n_rows"]), int(z["next_row"])


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
