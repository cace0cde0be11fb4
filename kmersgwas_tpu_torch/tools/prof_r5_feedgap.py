"""Where the warm feed of the dtable route spends its time, pass by pass
(port of tools/prof_r5_feedgap.py).

    python -m kmersgwas_tpu_torch.tools.prof_r5_feedgap [n_rows]
        [--batch B] [--device cuda|cpu] [--workdir DIR]

Over the bench's synthetic population (bench._synthetic_pop, n_rows
default 8,000,000, its .dtable), each pass streams every row once into a
(B, W32) staging buffer (B default 2,000,000), warm (after one untimed
pass), best of 3:

  A  the production feed (dtable_feed on the prefetch thread) + copyto
  B  as A, inline (no prefetch thread)
  C  memmap slices + copyto only (no readahead advice, page touch or
     row-id encode)
  D  copyto from a warm anonymous copy of one batch (no memmap at all)
  E  pread() into the staging buffer (no mapping)
  F  the port's whole feed to the device: dtable_feed, the staging (a
     pinned ring on the card) and the copies to `--device`
     (pipeline/feed.device_batches), synchronized at the end

D against C isolates the file-backed mapping, B against A the prefetch
thread, C against B the feed's per-batch extras, F against A the pinned
staging and the copy to the card. One JSON line per pass on stdout:
{"pass", "rows_per_s", "gb_per_s" (planes bytes), "rows", "batch",
"device", "card"}.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from .. import bench
from ..core.dtable import DTableReader
from ..pipeline import feed as feed_mod
from ..utils import require_device


def timed(fn, n_rows, plane_bytes, reps=3) -> tuple[float, float]:
    """(rows/s, GB/s) of the best of `reps` timed calls of fn after one
    warm call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return n_rows / best, n_rows * plane_bytes / best / 1e9


def main(n_rows: int = 8_000_000, batch: int = 2_000_000, device="cuda",
         workdir: str = bench.WORKDIR) -> list:
    dev = require_device(device)
    card = bench.card_line(dev)
    _, dtable, *_ = bench._synthetic_pop(n_rows, workdir)
    dt = DTableReader(dtable)
    w32 = dt.hdr.w32
    stage = np.empty((batch, w32), np.uint32)
    nb = dt.hdr.n_rows
    plane_bytes = w32 * 4

    def pass_a():
        for _, packed, *_ in feed_mod._prefetch(
                feed_mod.dtable_feed(dt, batch), depth=2):
            np.copyto(stage[: len(packed)], packed)

    def pass_b():
        for _, packed, *_ in feed_mod.dtable_feed(dt, batch):
            np.copyto(stage[: len(packed)], packed)

    def pass_c():
        for s in range(0, nb, batch):
            e = min(s + batch, nb)
            np.copyto(stage[: e - s], dt.planes[s:e])

    anon = np.array(dt.planes[:batch])     # one warm anonymous batch

    def pass_d():
        for s in range(0, nb, batch):
            e = min(s + batch, nb)
            np.copyto(stage[: e - s], anon[: e - s])

    fd = os.open(dt.path, os.O_RDONLY)
    off0 = dt.planes.offset

    def pass_e():
        mv = memoryview(stage).cast("B")
        for s in range(0, nb, batch):
            want = (min(s + batch, nb) - s) * plane_bytes
            got = 0
            while got < want:
                got += os.preadv(fd, [mv[got:want]],
                                 off0 + s * plane_bytes + got)

    def pass_f():
        for _ in feed_mod.device_batches(feed_mod.dtable_feed(dt, batch),
                                         dev, batch, w32):
            pass
        bench._sync(dev)

    out = []
    try:
        for label, fn in (
                ("A production feed (prefetch thread)", pass_a),
                ("B production feed, inline (no thread)", pass_b),
                ("C memmap slice -> copyto only", pass_c),
                ("D anon -> copyto (no memmap)", pass_d),
                ("E pread -> staging (no mapping)", pass_e),
                (f"F device_batches to {dev.type}", pass_f)):
            rate, gbps = timed(fn, nb, plane_bytes)
            line = {"pass": label, "rows_per_s": rate, "gb_per_s": gbps,
                    "rows": nb, "batch": batch, "device": dev.type,
                    "card": card}
            print(json.dumps(line), flush=True)
            out.append(line)
    finally:
        os.close(fd)
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m kmersgwas_tpu_torch.tools.prof_r5_feedgap",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("n_rows", nargs="?", type=int, default=8_000_000)
    ap.add_argument("--batch", type=int, default=2_000_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workdir", default=bench.WORKDIR,
                    help="where the synthetic table is built (and reused)")
    a = ap.parse_args(argv)
    main(a.n_rows, a.batch, a.device, a.workdir)


if __name__ == "__main__":
    _cli()
