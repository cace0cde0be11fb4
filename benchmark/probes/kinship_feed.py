"""The kinship feed's capacity alone: the cell's dtable drained through the
port's `pipeline.feed.kinship_feed` on its prefetch thread, each batch taken
by a staging copy that stands in for the pinned copy (the feed pass of
kmersgwas_tpu_torch/bench.py `kinship_streaming`, warm, copied). Rows/s over
a pass, the best of two passes after one that settles the page cache."""
from __future__ import annotations

import time

import numpy as np


def run(cell) -> float:
    from kmersgwas_tpu_torch.core.dtable import DTableReader
    from kmersgwas_tpu_torch.pipeline import feed

    dt = DTableReader(cell.dtable)
    stage = np.empty((cell.rows, dt.hdr.w32), np.uint32)

    def one_pass() -> float:
        t0 = time.perf_counter()
        fed = 0
        for _, r, planes in feed._prefetch(feed.kinship_feed(dt, cell.rows),
                                           depth=2):
            np.copyto(stage[:r], planes)
            fed += r
        return fed / (time.perf_counter() - t0)

    one_pass()
    return max(one_pass(), one_pass())
