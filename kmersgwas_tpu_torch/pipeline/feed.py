"""Host feed over a device-native .dtable, and its staging to the card.

`dtable_feed` is a jax-free copy of kmersgwas_tpu/pipeline/feed.py
`dtable_feed` (that module imports kmersgwas_tpu.ops.topk, which imports
jax) with the same contract (tests/test_feed.py): a full batch is the raw
memmap slice, the padded tail has zeroed rows and popcounts, and
`pos_after` is the exact dtable row index after the batch.

Host-to-device copies are asynchronous only from pinned memory, so batches
go to the card through a `PinnedRing`: a few pinned staging buffers, each
guarded by a CUDA event recorded after its copy was enqueued, so a buffer
is never overwritten while its copy is in flight.
"""
from __future__ import annotations

import os
import queue

import numpy as np
import torch

from ..ops import topk as topk_ops


class _Scratch:
    """Lazily-allocated, reused pad buffers for the (single) tail batch
    (copy of kmersgwas_tpu.pipeline.feed._Scratch)."""

    def __init__(self, pad_to: int, w32: int):
        self.pad_to = pad_to
        self.w32 = w32
        self.packed = None
        self.popcnt = None
        self.rows = None

    def pad(self, planes, pc, rows):
        if self.packed is None:
            self.packed = np.zeros((self.pad_to, self.w32), np.uint32)
            self.popcnt = np.zeros(self.pad_to, np.float32)
            self.rows = np.zeros(self.pad_to, np.int64)
        r = len(rows)
        self.packed[:r] = planes
        self.packed[r:] = 0
        self.popcnt[:r] = pc
        self.popcnt[r:] = 0.0
        self.rows[:r] = rows
        self.rows[r:] = 0
        return self.packed, self.popcnt, self.rows


def dtable_feed(dt, pad_to: int, *, start_row: int = 0,
                readahead: bool = True, want_patterns: bool = False):
    """Yield transfer-ready batches from a core.dtable.DTableReader (copy of
    kmersgwas_tpu.pipeline.feed.dtable_feed).

    Yields (r, packed, popcnt_f32, row_lo, row_hi, pos_after, pats) where
    `packed` is (pad_to, w32) uint32 — the raw memmap slice for full batches
    (zero-copy) or the padded scratch for the final partial one — r is the
    number of valid rows, and pos_after is the dtable row index right after
    this batch (the checkpoint resume position). `pats` is the unpadded
    planes slice when `want_patterns`."""
    hdr = dt.hdr
    scratch = _Scratch(pad_to, hdr.w32)
    plane_bytes = hdr.w32 * 4
    fd = os.open(dt.path, os.O_RDONLY) if readahead else None
    planes_off = dt.planes.offset

    def advise(row0: int) -> None:
        if fd is None or row0 >= hdr.n_rows:
            return
        n = min(pad_to, hdr.n_rows - row0)
        try:
            os.posix_fadvise(fd, planes_off + row0 * plane_bytes,
                             n * plane_bytes, os.POSIX_FADV_WILLNEED)
        except OSError:
            pass

    v3 = dt.pop32 is not None           # zero-prep sections present
    try:
        advise(start_row)
        for s in range(start_row, hdr.n_rows, pad_to):
            e = min(s + pad_to, hdr.n_rows)
            r = e - s
            advise(e)
            planes = dt.planes[s:e]
            if r == pad_to:
                if v3:
                    pc = dt.pop32[s:e]
                    lo, hi = dt.row_lo[s:e], dt.row_hi[s:e]
                else:
                    pc = dt.popcnt[s:e].astype(np.float32)
                    lo, hi = topk_ops.encode_rows(np.asarray(dt.src_rows[s:e]))
                # touch one byte per 4 KB page so the staging copy reads
                # warm cache
                stride = max(1, 4096 // plane_bytes)
                np.add.reduce(planes[::stride, 0], dtype=np.uint64)
                packed, popcnt = planes, pc
            else:
                pc = (dt.pop32[s:e] if v3
                      else dt.popcnt[s:e].astype(np.float32))
                rows = np.asarray(dt.src_rows[s:e])
                packed, popcnt, rows_p = scratch.pad(planes, pc, rows)
                lo, hi = topk_ops.encode_rows(rows_p)
            pats = np.asarray(planes) if want_patterns else None
            yield r, packed, popcnt, lo, hi, e, pats
    finally:
        if fd is not None:
            os.close(fd)


def host_tensors(packed, popcnt, lo, hi):
    """One batch's numpy arrays -> CPU tensors (copies: memmap slices are
    read-only, and the tail scratch is reused). Planes become the int32
    view of their bits (ops/bitplanes.py)."""
    return (torch.from_numpy(np.array(packed, np.uint32).view(np.int32)),
            torch.from_numpy(np.array(popcnt, np.float32)),
            torch.from_numpy(np.array(lo, np.int32)),
            torch.from_numpy(np.array(hi, np.int32)))


class _Slot:
    def __init__(self, rows: int, w32: int):
        self.tensors = (
            torch.empty((rows, w32), dtype=torch.int32, pin_memory=True),
            torch.empty(rows, dtype=torch.float32, pin_memory=True),
            torch.empty(rows, dtype=torch.int32, pin_memory=True),
            torch.empty(rows, dtype=torch.int32, pin_memory=True))
        self.event = torch.cuda.Event()


class PinnedRing:
    """Pinned staging buffers for one batch shape (rows, w32).

    `stage` (run on the feed's prefetch thread) takes a free buffer, waits
    for its previous copy to the card to finish, and fills it; `upload`
    (the main thread) enqueues the asynchronous copies on the current
    stream, records the buffer's event behind them and frees the buffer.
    With a prefetch queue of depth d, d + 2 buffers keep both threads busy.
    """

    def __init__(self, n_slots: int, rows: int, w32: int):
        self._free: queue.Queue = queue.Queue()
        for _ in range(n_slots):
            self._free.put(_Slot(rows, w32))

    def stage(self, packed, popcnt, lo, hi) -> _Slot:
        slot = self._free.get()
        slot.event.synchronize()        # its last copy to the card is done
        dst = slot.tensors
        np.copyto(dst[0].numpy(), np.asarray(packed).view(np.int32))
        np.copyto(dst[1].numpy(), popcnt)
        np.copyto(dst[2].numpy(), lo)
        np.copyto(dst[3].numpy(), hi)
        return slot

    def upload(self, slot: _Slot, device: torch.device):
        out = tuple(t.to(device, non_blocking=True) for t in slot.tensors)
        slot.event.record(torch.cuda.current_stream(device))
        self._free.put(slot)
        return out
