"""The scan feed's capacity alone: the cell's dtable drained through the
port's `pipeline.feed.dtable_feed` on its prefetch thread, each batch taken
by a staging copy that stands in for the pinned copy (the method of
kmersgwas_tpu_torch/bench.py `measure_host_feed`, warm, copied). Rows/s
over the full-size batches of a pass, the best of two passes after one that
settles the page cache."""
from __future__ import annotations

import time

import numpy as np


def run(cell) -> float:
    from kmersgwas_tpu_torch.core.dtable import DTableReader
    from kmersgwas_tpu_torch.ops import _cuda
    from kmersgwas_tpu_torch.pipeline import feed

    dt = DTableReader(cell.dtable)
    pad_to = -(-cell.rows // _cuda.TILE_ROWS) * _cuda.TILE_ROWS
    stage = np.empty((pad_to, dt.hdr.w32), np.uint32)

    def one_pass() -> float:
        t0 = time.perf_counter()
        fed, full_rows, full_t = 0, 0, None
        for r, packed, *_ in feed._prefetch(feed.dtable_feed(dt, pad_to),
                                            depth=2):
            np.copyto(stage[:len(packed)], packed)
            fed += r
            if r == pad_to:
                full_rows, full_t = fed, time.perf_counter()
        if full_t is not None:
            return full_rows / (full_t - t0)
        return fed / (time.perf_counter() - t0)

    one_pass()
    return max(one_pass(), one_pass())
