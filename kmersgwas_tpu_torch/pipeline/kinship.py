"""Kinship-from-table driver (port of kmersgwas_tpu/pipeline/kinship.py,
the emma_kinship_kmers equivalent).

Streams MAC-filtered table batches into the exact +-1 Gram accumulator
(ops/kinship.py). Reference: src/emma_kinship_kmers.cpp:77-111 — batches of
2^20 rows, min_count = ceil(n * maf), normalize by the number of k-mers
used, diagonal 1. On the card every batch goes through the kinship_gram
kernel; on the CPU the same driver runs its plain version.

With `mesh=` (parallel/sharding.Mesh) each batch is cut into row shards,
each accumulated into its own int32 partial on its device with no
exchange per batch (ops/kinship.KinshipAccumulator); the partials meet in
the host int64 total at flush, so the matrix is bit-identical to the
single-device one for any shard count. The multi-process driver is
parallel/multihost.run_distributed_kinship.
"""
from __future__ import annotations

import math
import os
from collections import deque

import numpy as np

from ..core.table import KmersTableReader
from ..ops.kinship import KinshipAccumulator
from ..parallel import sharding as shard_mod
from ..utils import drain, span, step_event
from . import checkpoint as ckpt
from . import feed as feed_mod

# bounded dispatch: wait for the batch from _INFLIGHT batches ago before
# starting another (kmersgwas_tpu/pipeline/kinship.py:122-135)
_INFLIGHT = 4
_PREFETCH = 2


def table_planes(reader: KmersTableReader, batch_size: int, min_count: int,
                 *, start_row: int = 0, end_row: int | None = None):
    """(r, planes, pos_after) items of the raw table's MAC-passing rows in
    [start_row, end_row), pos_after the .table row after the batch."""
    for b in reader.iter_batches(batch_size, min_count, start_row=start_row,
                                 end_row=end_row):
        yield b.n_rows, b.packed, int(b.row_index[-1]) + 1


def dtable_planes(dt, batch_size: int, *, start_row: int = 0):
    """(r, planes, pos_after) items of a .dtable from `start_row`,
    pos_after the dtable row after the batch."""
    for s, r, planes in feed_mod.kinship_feed(dt, batch_size,
                                              start_row=start_row):
        yield r, planes, s + r


def accumulate_stream(acc: KinshipAccumulator, items, dev, *, batch_size: int,
                      w32: int, checkpoint_path: str | None = None,
                      checkpoint_every: int = 50, stream: str = "table",
                      meta: dict | None = None, progress=None) -> None:
    """Stage a stream of (r, planes, pos_after) items to `dev` and add each
    batch's rows to `acc`, with the bounded in-flight window; every
    `checkpoint_every` batches flush the partial and save the total and
    the position after the batch."""
    inflight: deque = deque()
    batch_i = 0
    for r, planes, pos_after in feed_mod.device_planes(
            items, dev, batch_size, w32, depth=_PREFETCH):
        acc.add(planes, r)
        inflight.append([step_event(d) for d in acc.devices])
        if len(inflight) > _INFLIGHT:
            drain(inflight.popleft())
        batch_i += 1
        if checkpoint_path and batch_i % checkpoint_every == 0:
            with span("checkpoint_save"):
                acc.flush()
                ckpt.save_kinship_state(checkpoint_path, acc.total,
                                        acc.n_rows, pos_after,
                                        stream=stream, meta=meta)
        if progress is not None:
            progress(r)
    while inflight:
        drain(inflight.popleft())


@span("kinship_from_table", job=True)
def kinship_from_table(table_base: str, *, device, maf: float = 0.05,
                       batch_size: int = 1 << 20, names_to_use=None,
                       checkpoint_path: str | None = None,
                       checkpoint_every: int = 50, mesh=None,
                       dtable_cache: str | None = None,
                       progress=None) -> np.ndarray:
    """The kinship matrix (N, N) f64 of the table's MAF-passing k-mers.

    Arguments as kmersgwas_tpu.pipeline.kinship.kinship_from_table, plus
    `device` ("cuda" or "cpu", required: "cuda" without a card raises).
    dtable_cache: a device-native pre-packed table (core/dtable), built
    when the file is absent and used only when its stored min_count,
    n_used and accession subset match this call's filter; a stale cache is
    left alone and the raw table is streamed instead, so the accumulated
    row set is always the raw route's. Checkpoints hold exact positions,
    tagged with the row numbering they index, and are the same with or
    without a mesh. mesh: an optional parallel/sharding.Mesh (default:
    one shard on `device`); every batch is cut into its row shards, each
    accumulated into its own partial (ops/kinship.KinshipAccumulator).
    Batches are staged on the first shard's device, whose kind `device`
    must name. Traced (utils.span), the job span `kinship_from_table`
    holds the feed's spans, the accumulator's, `drain` and
    `checkpoint_save`."""
    dev, mesh = shard_mod.home_device(mesh, device)
    reader = KmersTableReader(table_base, names_to_use=names_to_use)
    min_count = math.ceil(reader.n_used * maf)
    acc = KinshipAccumulator(n_used=reader.n_used, n_pad=reader.w32 * 32,
                             mesh=mesh)
    dt = None
    if dtable_cache:
        from ..core import dtable as dt_mod
        if not os.path.exists(dtable_cache):
            dt_mod.build_dtable(table_base, dtable_cache,
                                names_to_use=names_to_use,
                                min_count=min_count)
        dt = dt_mod.open_cache(dtable_cache, min_count=min_count,
                               n_used=reader.n_used,
                               names_hash=dt_mod.names_hash_of(reader.names))
    stream = "dtable" if dt is not None else "table"
    meta = {"table_rows": reader.n_rows_total, "n_used": reader.n_used,
            "min_count": min_count}
    start_row = 0
    if checkpoint_path:
        resumed = ckpt.load_kinship_state(checkpoint_path, stream=stream,
                                          meta=meta)
        if resumed is not None:
            acc.total, acc.n_rows, start_row = resumed
    items = (dtable_planes(dt, batch_size, start_row=start_row)
             if dt is not None else
             table_planes(reader, batch_size, min_count,
                          start_row=start_row))
    accumulate_stream(acc, items, dev, batch_size=batch_size, w32=reader.w32,
                      checkpoint_path=checkpoint_path,
                      checkpoint_every=checkpoint_every, stream=stream,
                      meta=meta, progress=progress)
    return acc.finalize()


# copy of kmersgwas_tpu.pipeline.kinship.write_kinship
def write_kinship(path, K: np.ndarray) -> None:
    """Tab-separated kinship matrix, like emma_kinship_kmers' stdout TSV
    (src/emma_kinship_kmers.cpp:104-111)."""
    with open(str(path), "w") as f:
        for row in K:
            f.write("\t".join(repr(float(v)) if v != int(v) else str(int(v))
                              for v in row) + "\n")


# copy of kmersgwas_tpu.pipeline.kinship.read_kinship
def read_kinship(path) -> np.ndarray:
    return np.loadtxt(str(path), delimiter="\t", dtype=np.float64, ndmin=2)
