"""Host feeds over a .table or a device-native .dtable, and their staging
to the device.

`dtable_feed` is a jax-free copy of kmersgwas_tpu/pipeline/feed.py
`dtable_feed` (that module imports kmersgwas_tpu.ops.topk, which imports
jax) with the same contract (tests/test_feed.py): a full batch is the raw
memmap slice, the padded tail has zeroed rows and popcounts, and
`pos_after` is the exact dtable row index after the batch. `table_feed`
gives the raw table's MAC-filtered batches the same shape. `kinship_feed`
(a copy of the JAX package's) yields the dtable's planes alone, for the
kinship accumulator.

Host-to-device copies are asynchronous only from pinned memory, so batches
go to the card through a `PinnedRing`: a few pinned staging buffers, each
guarded by a CUDA event recorded after its copy was enqueued, so a buffer
is never overwritten while its copy is in flight. `device_batches` (scan
batches) and `device_planes` (kinship planes) run a feed and its staging on
a prefetch thread.

Traced (utils.span, utils.count): on the consumer's thread `ring_alloc`
(a ring's pinned buffers), `feed_wait` and `upload`; on the prefetch
thread, under the consumer's job, `feed_read`, `feed_put` and the ring's
`ring_wait` (the slot's previous copy) and `ring_copy` (the pinned copy);
the counters `feed.batches`, `feed.rows`, `feed.staged_bytes` and
`ring.stalls` (a slot whose copy had not finished when staging took it).
"""
from __future__ import annotations

import os
import queue

import numpy as np
import torch

from .. import utils
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


def table_feed(reader, batch_rows: int, pad_to: int, min_count: int, *,
               start_row: int = 0, end_row: int | None = None,
               want_patterns: bool = False):
    """Yield batches of <= batch_rows of a KmersTableReader's MAC-passing
    rows in [start_row, end_row), in dtable_feed's form: (r, packed,
    popcnt_f32, row_lo, row_hi, pos_after, pats) padded to `pad_to` rows,
    pos_after the .table row after the batch's last row."""
    for b in reader.iter_batches(batch_rows, min_count, start_row=start_row,
                                 end_row=end_row):
        r = len(b.row_index)
        packed = np.zeros((pad_to, reader.w32), np.uint32)
        packed[:r] = b.packed
        popcnt = np.zeros(pad_to, np.float32)
        popcnt[:r] = b.popcnt
        rows = np.zeros(pad_to, np.int64)
        rows[:r] = b.row_index
        lo, hi = topk_ops.encode_rows(rows)
        pats = np.asarray(b.packed) if want_patterns else None
        yield r, packed, popcnt, lo, hi, int(b.row_index[-1]) + 1, pats


# copy of kmersgwas_tpu.pipeline.feed.kinship_feed
def kinship_feed(dt, batch_size: int, *, start_row: int = 0,
                 readahead: bool = True):
    """Yield (batch_start, n_rows, planes) memmap slices with readahead for
    the kinship accumulator: zero-copy (the staging copy is the single
    byte-touch); pair with a prefetch thread so page-in overlaps the
    device GEMM."""
    hdr = dt.hdr
    plane_bytes = hdr.w32 * 4
    fd = os.open(dt.path, os.O_RDONLY) if readahead else None
    planes_off = dt.planes.offset

    def advise(row0: int) -> None:
        if fd is None or row0 >= hdr.n_rows:
            return
        n = min(batch_size, hdr.n_rows - row0)
        try:
            os.posix_fadvise(fd, planes_off + row0 * plane_bytes,
                             n * plane_bytes, os.POSIX_FADV_WILLNEED)
        except OSError:
            pass

    try:
        advise(start_row)
        for s in range(start_row, hdr.n_rows, batch_size):
            e = min(s + batch_size, hdr.n_rows)
            advise(e)
            planes = dt.planes[s:e]
            stride = max(1, 4096 // plane_bytes)
            np.add.reduce(planes[::stride, 0], dtype=np.uint64)  # warm pages
            yield s, e - s, planes
    finally:
        if fd is not None:
            os.close(fd)


# kmersgwas_tpu.pipeline.scan._prefetch, with a staging step and spans
def _prefetch(iterator, depth: int = 2, stage=None):
    """Run `iterator` on a background thread, buffering `depth` items, so
    host-side batch prep overlaps device compute; `stage`, if given, maps
    each item on that thread. Traced (utils.span): `feed_wait`, the
    consumer waiting for an item; on the thread, under the consumer's job,
    `feed_read` (the iterator's next) and `feed_put` (blocked on a full
    queue)."""
    import threading
    q = queue.Queue(maxsize=depth)
    _END = object()
    err = []
    ctx = utils.carry()

    def worker():
        with utils.carried(ctx):
            try:
                it = iter(iterator)
                while True:
                    with utils.span("feed_read"):
                        item = next(it, _END)
                    if item is _END:
                        break
                    if stage is not None:
                        item = stage(item)
                    with utils.span("feed_put"):
                        q.put(item)
            except BaseException as e:   # propagate into the consumer
                err.append(e)
            finally:
                q.put(_END)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        with utils.span("feed_wait"):
            item = q.get()
        if item is _END:
            break
        yield item
    t.join()
    if err:
        raise err[0]


def _count_staged(r: int, arrays) -> None:
    """The feed's counters, for one batch staged."""
    if utils.recording():
        utils.count("feed.batches")
        utils.count("feed.rows", r)
        utils.count("feed.staged_bytes", sum(np.asarray(a).nbytes
                                             for a in arrays))


def device_batches(batches, device: torch.device, pad_to: int, w32: int,
                   depth: int = 2):
    """Run a feed (table_feed or dtable_feed) and the staging of its batches
    on a prefetch thread, `depth` batches ahead. Returns an iterator of (r,
    (packed, popcnt, row_lo, row_hi) on `device`, pos_after, pats). On the
    card the batches go through a PinnedRing, allocated here (set-up, not
    stream time), and their copies are enqueued, on the current stream, as
    each is taken."""
    ring = (PinnedRing(depth + 2, [((pad_to, w32), torch.int32),
                                   ((pad_to,), torch.float32),
                                   ((pad_to,), torch.int32),
                                   ((pad_to,), torch.int32)])
            if device.type == "cuda" else None)

    def stage(item):
        r, packed, popcnt, lo, hi, pos_after, pats = item
        arrays = (packed, popcnt, lo, hi)
        _count_staged(r, arrays)
        staged = ring.stage(*arrays) if ring else host_tensors(*arrays)
        return r, staged, pos_after, pats

    return ((r, ring.upload(staged, device) if ring else staged, pos_after,
             pats)
            for r, staged, pos_after, pats in _prefetch(batches, depth,
                                                        stage))


def device_planes(feed, device: torch.device, rows: int, w32: int,
                  depth: int = 2):
    """Run a feed of (r, planes, pos_after) items, planes (r, w32) uint32
    with r <= rows, and the staging of the planes on a prefetch thread,
    `depth` batches ahead. Returns an iterator of (r, planes on `device` as
    int32, pos_after). On the card the planes arrive in a (rows, w32)
    buffer of a PinnedRing whose rows past r are stale (the kinship kernel
    reads only the first r); on the CPU they are an (r, w32) copy."""
    ring = (PinnedRing(depth + 2, [((rows, w32), torch.int32)])
            if device.type == "cuda" else None)

    def stage(item):
        r, planes, pos_after = item
        _count_staged(r, (planes,))
        staged = (ring.stage(planes) if ring else torch.from_numpy(
            np.array(planes, np.uint32).view(np.int32)))
        return r, staged, pos_after

    return ((r, ring.upload(staged, device)[0] if ring else staged,
             pos_after)
            for r, staged, pos_after in _prefetch(feed, depth, stage))


def host_tensors(packed, popcnt, lo, hi):
    """One batch's numpy arrays -> CPU tensors (copies: memmap slices are
    read-only, and the tail scratch is reused). Planes become the int32
    view of their bits (ops/bitplanes.py)."""
    return (torch.from_numpy(np.array(packed, np.uint32).view(np.int32)),
            torch.from_numpy(np.array(popcnt, np.float32)),
            torch.from_numpy(np.array(lo, np.int32)),
            torch.from_numpy(np.array(hi, np.int32)))


class _Slot:
    def __init__(self, specs):
        self.tensors = tuple(torch.empty(shape, dtype=dtype, pin_memory=True)
                             for shape, dtype in specs)
        self.event = torch.cuda.Event()


class PinnedRing:
    """Pinned staging buffers for one batch layout: `specs` lists the
    (shape, dtype) of each array of a batch.

    `stage` (run on the feed's prefetch thread) takes a free buffer, waits
    for its previous copy to the card to finish, and fills it (the leading
    rows of each array; uint32 planes as their int32 view); `upload` (the
    main thread) enqueues the asynchronous copies on the current stream,
    records the buffer's event behind them and frees the buffer. With a
    prefetch queue of depth d, d + 2 buffers keep both threads busy.
    """

    @utils.span("ring_alloc")
    def __init__(self, n_slots: int, specs):
        self._free: queue.Queue = queue.Queue()
        for _ in range(n_slots):
            self._free.put(_Slot(specs))

    def stage(self, *arrays) -> _Slot:
        slot = self._free.get()
        if utils.recording() and not slot.event.query():
            utils.count("ring.stalls")
        with utils.span("ring_wait"):
            slot.event.synchronize()    # its last copy to the card is done
        with utils.span("ring_copy"):
            for dst, a in zip(slot.tensors, arrays):
                a = np.asarray(a)
                if a.dtype == np.uint32:
                    a = a.view(np.int32)
                np.copyto(dst.numpy()[:len(a)], a)
        return slot

    @utils.span("upload")
    def upload(self, slot: _Slot, device: torch.device):
        out = tuple(t.to(device, non_blocking=True) for t in slot.tensors)
        slot.event.record(torch.cuda.current_stream(device))
        self._free.put(slot)
        return out
