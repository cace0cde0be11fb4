"""Where a scan step's time goes, by piece (port of tools/prof_step.py).

    python -m kmersgwas_tpu_torch.tools.prof_step [--compact | --steady]
        [--device cuda|cpu] [--rows R] [--n N] [--p P] [--k K]

Default mode, per batch of R rows (default 2^21) at N=1008, P=101,
K=10001: the score_bmax kernel alone (score_batch_t_bmax: scores and
16-lane block maxima), the score_t kernel alone, the block-max extraction
alone (top_k_from_bmax at c = 512 and 2048) and its parts, stable top-k
over small widths and a flush-sized top-k. `--compact` times the `cand_c`
step (the score_tilemax kernel, cand_c 128) over 12 distinct batches
after a warm-up; `--steady` the append path alone (thresh forced to 1e30,
so every batch appends) in `cand_c` and `cand_w` modes. Batches are uniform random bits from numpy's generator
with seed 0, as in the JAX tool.

One JSON line per measurement on stdout: {"tool", "name", "ms",
"mkmers_per_s" (where a batch of rows is scored), "device", "card"}; ms is
the mean of `iters` calls between two synchronizations of the device.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .. import bench
from ..ops import _cuda, bitplanes
from ..ops import scanstep as ss
from ..ops import score as score_ops
from ..ops import topk as topk_ops
from ..utils import require_device

MIN_COUNT = 51


def timeit(fn, dev, iters=30, warmup=3) -> float:
    """Mean seconds of one `fn()` over `iters` calls after `warmup`."""
    for _ in range(warmup):
        fn()
    bench._sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    bench._sync(dev)
    return (time.perf_counter() - t0) / iters


def make_batch(rng, rows: int, w32: int, first_row: int, dev):
    """(packed, popcnt, row_lo, row_hi) of `rows` uniform random rows on
    `dev`, ids from first_row."""
    packed = torch.from_numpy(rng.integers(0, 1 << 32, size=(rows, w32),
                                           dtype=np.uint64)
                              .astype(np.uint32).view(np.int32)).to(dev)
    lo, hi = topk_ops.encode_rows(np.arange(first_row, first_row + rows))
    return (packed, bitplanes.popcount_rows(packed),
            torch.from_numpy(lo).to(dev), torch.from_numpy(hi).to(dev))


class Report:
    def __init__(self, dev, rows):
        self.dev, self.rows = dev, rows
        self.card = bench.card_line(dev)
        self.lines = []

    def __call__(self, name, t, scored=False):
        line = {"tool": "prof_step", "name": name, "ms": t * 1e3,
                "mkmers_per_s": self.rows / t / 1e6 if scored else None,
                "device": self.dev.type, "card": self.card}
        self.lines.append(line)
        print(json.dumps(line), flush=True)


def setup(device, rows, n, p):
    dev = require_device(device)
    n_pad = -(-n // 128) * 128
    rng = np.random.default_rng(0)
    y = rng.normal(size=(n, p)).astype(np.float32)
    yp, ysum = score_ops.prepare_phenotypes(y, n_pad, dev)
    return dev, rng, yp, ysum, n_pad // 32


def main(device="cuda", rows=1 << 21, n=1008, p=101, k=10001,
         iters=30) -> list:
    dev, rng, yp, ysum, w32 = setup(device, rows, n, p)
    rep = Report(dev, rows)
    packed, popcnt, _, _ = make_batch(rng, rows, w32, 0, dev)
    kw = dict(n_used=n, min_count=MIN_COUNT)
    rep("score+bmax kernel", timeit(lambda: score_ops.score_batch_t_bmax(
        packed, popcnt, yp, ysum, **kw), dev, iters), scored=True)
    rep("score kernel", timeit(lambda: score_ops.score_batch_t(
        packed, popcnt, yp, ysum, **kw), dev, iters), scored=True)
    sc, bmax = score_ops.score_batch_t_bmax(packed, popcnt, yp, ysum, **kw)
    for cand in (512, 2048):
        rep(f"bmax extract c={cand}", timeit(
            lambda c=cand: topk_ops.top_k_from_bmax(sc, bmax, c), dev,
            iters))
    rep("blocked_top_k(bmax, 513)", timeit(
        lambda: topk_ops.blocked_top_k(bmax, 513), dev, iters))
    rep("flat top_k(bmax, 513)", timeit(
        lambda: topk_ops.top_k(bmax, 513), dev, iters))
    for width in (1024, 2048, 8192):
        x = torch.randn(p, width, device=dev)
        rep(f"top_k ({p},{width}) k={min(128, width)}", timeit(
            lambda x=x, w=width: topk_ops.top_k(x, min(128, w)), dev, iters))
    x = torch.randn(p, k + 4096, device=dev)
    rep(f"flush top_k ({p},{k + 4096}) k={k}", timeit(
        lambda: topk_ops.top_k(x, k), dev, max(1, iters // 3)))
    return rep.lines


def compact(device="cuda", rows=1 << 21, n=1008, p=101, k=10001,
            n_batches=12, iters=96) -> list:
    dev, rng, yp, ysum, w32 = setup(device, rows, n, p)
    rep = Report(dev, rows)
    batches = [make_batch(rng, rows, w32, b * rows, dev)
               for b in range(n_batches)]
    kw = dict(n_used=n, min_count=MIN_COUNT)
    th = torch.full((p,), 100.0, device=dev)
    rep("tilemax kernel", timeit(lambda: score_ops.score_batch_t_tilemax(
        batches[0][0], batches[0][1], yp, ysum, th,
        tile_rows=_cuda.TILE_ROWS, **kw), dev), scored=True)
    cand_c = min(128, rows // _cuda.TILE_ROWS)
    state = ss.init_buffered_state(p, k, 3 * cand_c * 16, dev)
    counts = {}
    step_kw = dict(kw, cand_k=2048, tile_rows=_cuda.TILE_ROWS, cand_c=cand_c,
                   counts=counts)
    for b in batches:
        ss.scan_step_compact(state, *b, yp, ysum, **step_kw)
    i = iter(range(1 << 30))
    t = timeit(lambda: ss.scan_step_compact(
        state, *batches[next(i) % n_batches], yp, ysum, **step_kw), dev,
        iters, warmup=0)
    rep(f"compact step (warm buf_n={ss.settle(state).buf_n})", t,
        scored=True)
    return rep.lines


def steady(device="cuda", rows=1 << 21, n=1008, p=101, k=10001,
           n_batches=8, iters=96) -> list:
    """The append path alone: thresh forced to 1e30, so no lane is hot and
    every batch appends (the late-stream regime)."""
    dev, rng, yp, ysum, w32 = setup(device, rows, n, p)
    rep = Report(dev, rows)
    batches = [make_batch(rng, rows, w32, b * rows, dev)
               for b in range(n_batches)]
    for mode, cand in (("cand_c", dict(cand_c=min(256, rows // 128))),
                       ("cand_w", dict(cand_w=256))):
        width = 3 * cand["cand_c"] if mode == "cand_c" else 256
        state = ss.init_buffered_state(p, k, width * 16, dev)
        state.scores.fill_(1e30)
        state.thresh.fill_(1e30)
        counts = {}
        step_kw = dict(n_used=n, min_count=MIN_COUNT, cand_k=2048,
                       tile_rows=_cuda.TILE_ROWS, counts=counts, **cand)
        i = iter(range(1 << 30))
        t = timeit(lambda: ss.scan_step_compact(
            state, *batches[next(i) % n_batches], yp, ysum, **step_kw), dev,
            iters)
        if counts.get("fallback"):
            raise RuntimeError(f"append path not engaged: {counts}")
        rep(f"append path {mode} tile={_cuda.TILE_ROWS}", t, scored=True)
    return rep.lines


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m kmersgwas_tpu_torch.tools.prof_step",
        description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--compact", action="store_true")
    mode.add_argument("--steady", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--rows", type=int, default=1 << 21)
    ap.add_argument("--n", type=int, default=1008)
    ap.add_argument("--p", type=int, default=101)
    ap.add_argument("--k", type=int, default=10001)
    ap.add_argument("--iters", type=int, default=None)
    a = ap.parse_args(argv)
    fn = compact if a.compact else steady if a.steady else main
    kw = dict(device=a.device, rows=a.rows, n=a.n, p=a.p, k=a.k)
    if a.iters:
        kw["iters"] = a.iters
    fn(**kw)


if __name__ == "__main__":
    _cli()
