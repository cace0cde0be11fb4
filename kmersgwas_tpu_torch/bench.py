"""Association-scan throughput of the port on the card (port of the root
bench.py).

    python -m kmersgwas_tpu_torch.bench [--streaming | --kinship-streaming]
                                        [--device cuda|cpu]

Default: k-mers/second scored through the scan step of the single-process
scan (`scan_step_compact` in `cand_w` mode: the score_topw kernel on every
step, score_bmax on the exact fallbacks) over 101 phenotype columns at
N=1008 (1,024 lanes), top-10001, with 2^21-row steps. Every step scores a
fresh batch drawn on the card by the gen_planes kernel (ops/gen.py), so
the stream has a real scan's displacement statistics: early steps fall
back to the exact merge, later ones append. Steps run in synced windows of
S=16; after one warm window an adaptive ramp (the root bench's rule) takes
the early transient, and the headline is the median of 30 windows. One
JSON line on stdout, the card's name and power limit and the window times
on stderr.

--streaming: `pipeline.scan.associate` end to end on a synthetic table
(memmap -> prefetch thread -> pinned copy to the card -> step), with the
host-feed rates. --kinship-streaming: the kinship feed rate and the
end-to-end rate through the kinship accumulator (the kinship_gram kernel).

The shapes and constants are the root bench's; the tile is the port's
128-row tile (ops/_cuda.TILE_ROWS), since the root bench's 4096 is TPU
tuning. `cuda` without a card raises: there is no CPU run unless asked.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .core import formats
from .ops import _cuda, bitplanes
from .ops import gen as gen_ops
from .ops import scanstep as ss
from .ops import score as score_ops
from .pipeline import feed as feed_mod
from .utils import require_device

# the reference C++ SSE4.1 scan on the 32-core server of BASELINE.md (the
# root bench's denominator, bench.py:20-24)
BASELINE_KMERS_PER_SEC = 2.5e6

N_USED, N_PAD, P, K = 1008, 1024, 101, 10001
ROWS = 1 << 21                  # k-mers per scan step
MIN_COUNT = 51
CAND_W, CAND_K, CAND_Q, BUF_CAP = 256, 2048, 64, 12288
BENCH_SEED = 1 << 20            # the root bench's first generator seed
ROW_ID_LIMIT = 1 << 31          # row ids ride as (lo = base + r, hi = 0)
WORKDIR = os.path.join(_cuda.BUILD, "bench")


@dataclass(frozen=True)
class CardPeaks:
    """A card's dense peaks (NVIDIA's data sheet): bf16 tensor-core FLOP/s
    (the score step's GEMM is bf16 x exact 0/1 at precision "default"),
    int8 tensor-core op/s (the kinship Gram) and HBM bytes/s."""
    label: str
    bf16_flops: float
    int8_ops: float
    hbm_bytes: float


# by a substring of torch.cuda.get_device_name
CARD_PEAKS = (("H100 80GB HBM3",
               CardPeaks("NVIDIA H100 SXM", 989e12, 1979e12, 3.35e12)),)


def card_line(device: torch.device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or
    "cpu"."""
    if device.type != "cuda":
        return "cpu"
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return smi.stdout.strip().splitlines()[0]


def card_peaks(device: torch.device) -> CardPeaks | None:
    """The card's peaks, or None where CARD_PEAKS does not know it."""
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device)
    return next((pk for key, pk in CARD_PEAKS if key in name), None)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _synthetic_pop(n_rows: int, workdir: str):
    """Synthetic .table + matched .dtable cache, built once and reused
    (port of bench.py:34-64: the same rows from the same seed)."""
    from .core import dtable as dt_mod

    os.makedirs(workdir, exist_ok=True)
    base = os.path.join(workdir, f"pop{n_rows}")
    n, kmer_len = N_USED, 31
    names = [f"acc{i}" for i in range(n)]
    wf = (n + 63) // 64
    if not os.path.exists(base + ".table"):
        print("generating synthetic table...", file=sys.stderr, flush=True)
        rng = np.random.default_rng(0)
        with open(base + ".table.tmp", "wb") as f:
            formats.write_table_header(f, n, kmer_len)
            chunk = 1 << 20
            for s in range(0, n_rows, chunk):
                m = min(chunk, n_rows - s)
                rows = np.empty((m, 1 + wf), dtype="<u8")
                rows[:, 0] = np.arange(s, s + m, dtype=np.uint64) \
                    * np.uint64(97)
                rows[:, 1:] = rng.integers(0, 1 << 63, size=(m, wf),
                                           dtype=np.uint64)
                rows.tofile(f)
        formats.write_names(base, names)
        os.replace(base + ".table.tmp", base + ".table")
    dtable = base + ".dtable"
    if not os.path.exists(dtable):
        print("building dtable cache...", file=sys.stderr, flush=True)
        dt_mod.build_dtable(base, dtable, names_to_use=names,
                            min_count=MIN_COUNT)
    return base, dtable, names, n, kmer_len


def _drop_cache(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
    finally:
        os.close(fd)


def measure_host_feed(dtable: str, batch_size: int = 2_000_000,
                      tile: int = _cuda.TILE_ROWS):
    """Host-feed rates through the port's scan feed (pipeline/feed.py
    `dtable_feed` on a `_prefetch` thread), each batch consumed by a
    staging memcpy standing in for the pinned copy (port of bench.py:67-150).

    Returns (warm rows/s, cold rows/s, disk GB/s, warm rows/s at 512k-row
    batches): warm with the table in the page cache, at the production
    batch size; cold from disk with the prefetch overlap on; the raw
    sequential read rate of the file; warm at a 2^19-row quantum. The rates
    count full production-size batches only (the one padded tail batch of a
    pass is set-up that a long scan pays once)."""
    from .core.dtable import DTableReader

    dt = DTableReader(dtable)

    def make_pass(bs: int):
        pad_to = -(-bs // tile) * tile
        stage = np.empty((pad_to, dt.hdr.w32), np.uint32)

        def one_pass():
            t0 = time.perf_counter()
            fed = 0
            full_rows, full_t = 0, None
            for r, packed, pc, lo, hi, pos, pats in feed_mod._prefetch(
                    feed_mod.dtable_feed(dt, pad_to), depth=2):
                np.copyto(stage[: len(packed)], packed)
                fed += r
                if r == pad_to:
                    full_rows, full_t = fed, time.perf_counter()
            if full_t is not None and full_rows:
                return full_rows / (full_t - t0)
            return fed / (time.perf_counter() - t0)
        return one_pass

    one_pass = make_pass(batch_size)

    _drop_cache(dtable)
    fd = os.open(dtable, os.O_RDONLY)
    try:
        t0 = time.perf_counter()
        got = 0
        while got < min(dt.hdr.n_rows * dt.hdr.w32 * 4, 1 << 30):
            b = os.read(fd, 1 << 24)
            if not b:
                break
            got += len(b)
        disk_gbps = got / (time.perf_counter() - t0) / 1e9
    finally:
        os.close(fd)

    _drop_cache(dtable)
    cold = one_pass()
    one_pass()                      # settle the cache
    warm = max(one_pass(), one_pass())
    small = make_pass(1 << 19)
    small()
    warm_small = max(small(), small())
    return warm, cold, disk_gbps, warm_small


def _feed_note(warm, cold, disk_gbps, warm_small) -> None:
    print(f"host feed: warm {warm/1e6:.1f}M rows/s (512k-batch "
          f"{warm_small/1e6:.1f}M), cold {cold/1e6:.1f}M rows/s "
          f"(disk {disk_gbps:.2f} GB/s)", file=sys.stderr, flush=True)


def streaming(n_rows: int = 8_000_000, batch_size: int = 2_000_000,
              workdir: str = WORKDIR, device="cuda") -> dict:
    """End-to-end streaming scan: synthetic .table -> .dtable cache ->
    pipeline.scan.associate (memmap slices -> prefetch thread -> pinned
    copy to the card -> step), plus the host-feed rates of the same feed
    (port of bench.py:153-196). Prints and returns the JSON line."""
    from .pipeline import scan as scan_mod

    dev = require_device(device)
    print(card_line(dev), file=sys.stderr, flush=True)
    base, dtable, names, n, kmer_len = _synthetic_pop(n_rows, workdir)
    rng = np.random.default_rng(1)
    y = rng.normal(size=(n, P))

    warm, cold, disk_gbps, warm_small = measure_host_feed(dtable, batch_size)
    _feed_note(warm, cold, disk_gbps, warm_small)

    t0 = time.perf_counter()
    res = scan_mod.associate(base, names, y, [f"c{j}" for j in range(P)],
                             kmer_len=kmer_len, device=dev, n_top=K,
                             maf=0.05, mac=5, batch_size=batch_size,
                             dtable_cache=dtable, progress=lambda r: None)
    dt_scan = time.perf_counter() - t0
    kmers_per_sec = res.n_tested / dt_scan
    out = {
        "metric": "assoc_scan_streaming_kmers_per_sec",
        "value": round(kmers_per_sec, 1),
        "unit": f"kmers/s end-to-end (N={n}, P={P}, {res.n_tested} rows, "
                "memmap->prefetch->pinned copy->step)",
        "vs_baseline": round(kmers_per_sec / BASELINE_KMERS_PER_SEC, 3),
        "host_feed_rows_per_sec_warm": round(warm, 1),
        "host_feed_rows_per_sec_warm_512k_batch": round(warm_small, 1),
        "host_feed_rows_per_sec_cold": round(cold, 1),
        "disk_seq_read_gb_per_sec": round(disk_gbps, 3),
        "sub_stage_seconds": {k: round(v, 2) for k, v in res.timings.items()},
    }
    print(json.dumps(out), flush=True)
    out["n_tested"] = res.n_tested
    return out


def kinship_streaming(n_rows: int = 8_000_000, batch_size: int = 1 << 20,
                      workdir: str = WORKDIR, device="cuda") -> dict:
    """The kinship feed rate through the port's feed (pipeline/feed.py
    `kinship_feed` on a prefetch thread, a staging memcpy standing in for
    the pinned copy), then the end-to-end rate through the kinship
    accumulator (pinned ring -> kinship_gram kernel) (port of
    bench.py:199-263). Prints and returns the JSON line."""
    from .core.dtable import DTableReader, build_dtable
    from .ops.kinship import KinshipAccumulator
    from .pipeline import kinship as km

    dev = require_device(device)
    print(card_line(dev), file=sys.stderr, flush=True)
    base, _, names, n, kmer_len = _synthetic_pop(n_rows, workdir)
    dtable = base + ".kin.dtable"
    if not os.path.exists(dtable):
        print("building dtable cache...", file=sys.stderr, flush=True)
        build_dtable(base, dtable, names_to_use=names, min_count=MIN_COUNT)
    dt = DTableReader(dtable)
    stage = np.empty((batch_size, dt.hdr.w32), np.uint32)

    def feed_pass():
        t0 = time.perf_counter()
        fed = 0
        for s, r, planes in feed_mod._prefetch(
                feed_mod.kinship_feed(dt, batch_size), depth=2):
            np.copyto(stage[:r], planes)
            fed += r
        return fed / (time.perf_counter() - t0)

    _drop_cache(dtable)
    host_feed_cold = feed_pass()
    feed_pass()
    host_feed = max(feed_pass(), feed_pass())
    print(f"kinship feed: warm {host_feed/1e6:.1f}M rows/s, cold "
          f"{host_feed_cold/1e6:.1f}M rows/s", file=sys.stderr, flush=True)

    acc = KinshipAccumulator(n_used=dt.hdr.n_used, n_pad=dt.hdr.w32 * 32,
                             device=dev)
    _sync(dev)
    t0 = time.perf_counter()
    km.accumulate_stream(acc, km.dtable_planes(dt, batch_size), dev,
                         batch_size=batch_size, w32=dt.hdr.w32)
    acc.flush()
    e2e = acc.n_rows / (time.perf_counter() - t0)
    if acc.n_rows != dt.hdr.n_rows:
        raise RuntimeError(f"kinship accumulated {acc.n_rows} of "
                           f"{dt.hdr.n_rows} rows")
    out = {
        "metric": "kinship_feed_rows_per_sec",
        "value": round(host_feed, 1),
        "unit": f"rows/s host-feed bound, warm cache (N={n}, production "
                f"zero-copy feed, {acc.n_rows} rows; the kinship_gram "
                "kernel's own rate is timed by chip_smoke.py)",
        "host_feed_cold_cache_rows_per_sec": round(host_feed_cold, 1),
        "end_to_end_rows_per_sec": round(e2e, 1),
    }
    print(json.dumps(out), flush=True)
    return out


def make_window(yp, ysum, *, n_used: int, min_count: int, rows: int,
                steps: int, seed: int = BENCH_SEED,
                cand_w: int | None = CAND_W, cand_k: int = CAND_K,
                cand_q: int | None = CAND_Q,
                cand_c: int | None = None, cand_c2: int | None = None,
                col_group: int = 128, precision: str = "default",
                popcount: str = "fused", step=None,
                counts: dict | None = None):
    """-> window(state, step) -> next step: `steps` scan steps, step s
    scoring batch s of the generated stream under `seed` (gen_planes on
    yp's device), its rows numbered s*rows + r (lo = s*rows + r, hi = 0,
    so every id stays below 2^31). The state is updated in place.

    The step is `scan_step_compact` with the keywords given (cand_w None
    selects `cand_c` mode). popcount: "fused" (the generator writes them),
    "pass" (planes only, then the port's popcount pass) or "none" (planes
    only, pc None). step: a callable (state, packed, pc, row_lo, row_hi)
    run in place of the scan step (the probes time parts of a step)."""
    dev = yp.device
    w32 = yp.shape[0] // 32
    iota = torch.arange(rows, dtype=torch.int32, device=dev)
    hi0 = torch.zeros(rows, dtype=torch.int32, device=dev)
    if popcount not in ("fused", "pass", "none"):
        raise ValueError(f"popcount must be fused, pass or none, got "
                         f"{popcount!r}")
    if step is None:
        def step(state, packed, pc, lo, hi):
            ss.scan_step_compact(
                state, packed, pc, lo, hi, yp, ysum, n_used=n_used,
                min_count=min_count, cand_k=cand_k,
                tile_rows=_cuda.TILE_ROWS, cand_w=cand_w, cand_c=cand_c,
                cand_c2=cand_c2, cand_q=cand_q, precision=precision,
                col_group=col_group, counts=counts)

    def window(state, first: int) -> int:
        if (first + steps) * rows > ROW_ID_LIMIT:
            raise ValueError(f"steps up to {first + steps} of {rows} rows "
                             "number rows past 2^31")
        for s in range(first, first + steps):
            if popcount == "fused":
                packed, pc = gen_ops.gen_planes(rows, w32, seed, s, dev)
            else:
                packed = gen_ops.gen_planes(rows, w32, seed, s, dev,
                                            popcount=False)
                pc = bitplanes.popcount_rows(packed) \
                    if popcount == "pass" else None
            step(state, packed, pc, iota + s * rows, hi0)
            del packed, pc
        return first + steps
    return window


@dataclass
class BenchRun:
    """What `main` ran, for checks of its result: the final state, the
    phenotypes, the generator's seed and the steps it scored."""
    state: ss.BufferedTopKState
    y: np.ndarray
    seed: int
    steps: int
    rows: int
    counts: dict


def main(n_windows: int = 30, steps_per_window: int = 16, n_ramp: int = 6,
         *, device="cuda", feed_rows: int = 8_000_000,
         workdir: str = WORKDIR):
    """The headline: scan-step throughput over a generated stream on the
    card (port of bench.py:266-482). The host feed is measured first, on a
    `feed_rows`-row synthetic table in `workdir`. Prints the JSON line and
    returns (that dict, BenchRun)."""
    dev = require_device(device)
    card = card_line(dev)
    print(card, file=sys.stderr, flush=True)
    S = steps_per_window
    n_ramp_max = max(n_ramp, 24)
    if (1 + n_ramp_max + n_windows) * S * ROWS > ROW_ID_LIMIT:
        raise ValueError("the stream would number rows past 2^31")

    # the host-feed side of the end-to-end story, measured before the
    # stream (as the root bench does)
    _, dtable, *_ = _synthetic_pop(feed_rows, workdir)
    feed_warm, feed_cold, disk_gbps, feed_small = measure_host_feed(dtable)
    _feed_note(feed_warm, feed_cold, disk_gbps, feed_small)

    rng = np.random.default_rng(0)
    y = rng.normal(size=(N_USED, P)).astype(np.float32)
    yp, ysum = score_ops.prepare_phenotypes(y, N_PAD, dev)
    counts = {}
    window = make_window(yp, ysum, n_used=N_USED, min_count=MIN_COUNT,
                         rows=ROWS, steps=S, counts=counts)
    state = ss.init_buffered_state(P, K, BUF_CAP, dev)

    print("warm window (builds the kernels at first use)...",
          file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    step = window(state, 0)
    _sync(dev)
    print(f"warm window in {time.perf_counter() - t0:.1f}s", file=sys.stderr,
          flush=True)

    # ramp windows (bench.py:387-415): the early-stream transient (exact
    # fallbacks while the threshold rises), timed and reported but kept out
    # of the headline; ramp until the last few windows stop improving on
    # the earlier minimum and sit near it, at most n_ramp_max windows
    ramp_s = []
    for i in range(n_ramp_max):
        t0 = time.perf_counter()
        step = window(state, step)
        _sync(dev)
        ramp_s.append(time.perf_counter() - t0)
        if i + 1 >= n_ramp:
            prev_min = min(ramp_s[:-4])
            recent_min = min(ramp_s[-4:])
            converged = (recent_min > 0.95 * prev_min
                         and ramp_s[-1] < 1.3 * min(ramp_s)
                         and min(ramp_s) < 0.5 * ramp_s[0])
            if converged:
                break

    win_s = []
    for i in range(n_windows):
        t0 = time.perf_counter()
        step = window(state, step)
        _sync(dev)
        win_s.append(time.perf_counter() - t0)
    checksum = float(ss.settle(state).scores[:, 0].sum())
    if not np.isfinite(checksum):
        raise RuntimeError(f"checksum {checksum} is not finite")

    win_s = np.array(win_s)
    rates = S * ROWS / win_s
    med = float(np.median(rates))
    p10, p90 = float(np.percentile(rates, 10)), float(np.percentile(rates, 90))
    spread = (p90 - p10) / med
    med_step_ms = float(np.median(win_s)) / S * 1e3
    # the step's score GEMM: (rows, n_pad) x (n_pad, p), bf16 products on
    # the tensor cores' rate; useful FLOPs exclude the p -> 128 padding
    gemm_flops = 2.0 * ROWS * N_PAD * P
    peak = card_peaks(dev)
    mfu = (gemm_flops / (med_step_ms * 1e-3) / peak.bf16_flops
           if peak else None)
    gemm_floor_ms = gemm_flops / peak.bf16_flops * 1e3 if peak else None
    print("ramp ms:   " + " ".join(f"{t*1e3:.0f}" for t in ramp_s),
          file=sys.stderr)
    print("window ms: " + " ".join(f"{t*1e3:.0f}" for t in win_s),
          file=sys.stderr)
    print(f"median {med/1e6:.1f}M/s  p10 {p10/1e6:.1f}M  p90 {p90/1e6:.1f}M  "
          f"spread {spread:.2f}  step {med_step_ms:.2f} ms  mfu "
          f"{mfu if mfu is None else round(mfu, 4)}  branches {counts}  "
          f"({card})", file=sys.stderr, flush=True)
    if spread > 0.5:
        print("WARNING: steady-state window spread > 50%; the median "
              "remains the robust estimate", file=sys.stderr, flush=True)

    out = {
        "metric": "assoc_scan_kmers_per_sec_per_chip",
        "value": round(med, 1),
        "unit": f"kmers/s (N={N_USED}, P={P}, top-{K}; median of "
                f"{n_windows} synced {S}-step steady-state windows over a "
                "fresh-random on-device 2M-row/step stream; "
                f"{len(ramp_s)} adaptive ramp windows reported separately; "
                + (f"mfu against the {peak.label} dense bf16 tensor-core "
                   f"peak, {peak.bf16_flops / 1e12:g} TFLOP/s" if peak
                   else f"no bf16 peak known for {card}: mfu null") + ")",
        "vs_baseline": round(med / BASELINE_KMERS_PER_SEC, 3),
        "window_spread_p10_p90": round(spread, 3),
        "median_step_ms": round(med_step_ms, 3),
        "mfu": None if mfu is None else round(mfu, 4),
        "gemm_floor_ms": (None if gemm_floor_ms is None
                          else round(gemm_floor_ms, 3)),
        "ramp_window_ms": [round(t * 1e3) for t in ramp_s],
        "host_feed_rows_per_sec_warm": round(feed_warm, 1),
        "host_feed_rows_per_sec_warm_512k_batch": round(feed_small, 1),
        "host_feed_rows_per_sec_cold": round(feed_cold, 1),
        "disk_seq_read_gb_per_sec": round(disk_gbps, 3),
        # min(kernel, feed) at the same 2M-row batch size, both steady state
        "colocated_end_to_end_kmers_per_sec_bound":
            round(min(med, feed_warm), 1),
    }
    print(json.dumps(out), flush=True)
    return out, BenchRun(state=state, y=y, seed=BENCH_SEED, steps=step,
                         rows=ROWS, counts=counts)


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m kmersgwas_tpu_torch.bench",
                                 description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--streaming", action="store_true")
    mode.add_argument("--kinship-streaming", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the bench runs (cuda raises without a card)")
    a = ap.parse_args(argv)
    if a.streaming:
        streaming(device=a.device)
    elif a.kinship_streaming:
        kinship_streaming(device=a.device)
    else:
        main(device=a.device)


if __name__ == "__main__":
    _cli()
