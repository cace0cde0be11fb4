"""The step-budget and P-scaling probes of tools/prof_*.py on the port.

    python -m kmersgwas_tpu_torch.tools.probes <probe> [variant ...]
    python -m kmersgwas_tpu_torch.tools.probes all
        [--device cuda|cpu]

Each variant of the JAX probes (prof_r3, prof_r4, prof_r4b, prof_r5_feed,
prof_pscale, prof_r5_pscale, prof_r5_pcpad, prof_window, prof_window2,
prof_r5_epi) is one entry of VARIANTS with the probe's own parameters: P,
rows per step, S steps per synced window, the step mode and its cand_*,
col_group and buffer capacity, its warm, ramp and timed window counts, and
what is timed:
  latency       one tiny launch + synchronize per call (the probes' relay
                dispatch latency, which the card does not have);
  gen           the plane generator only (gen_planes, K6);
  gen+popcount  the generator without popcounts, then the popcount pass;
  floor         the generator and one kernel (score_topw K1, score_tilemax
                K3, score_t K4 or score_parity K8) at a fixed threshold;
  step          the generator and the full scan step, `scan_step_compact`,
                from a fresh state: warm windows (the kernels' build), then
                ramp windows (the threshold's early fallbacks; a variant
                with none times the ramp itself: "cold"), then the timed
                windows;
  pieces        prof_window2's post-kernel pieces of the `cand_c` step,
                cumulative: p0 K3 + the top-(c+1) tile maxima + the gathers,
                p1 + the two-key sort, p2 + the row-id gather, p3 + the
                buffered append.
Every window goes through `bench.make_window`. One JSON line per variant:
median and best step ms, rows/s, P*rows/s (tests/s), ms per 2M-row
equivalent, warm/ramp/timed window ms and branch counts, with the card's
name and power limit. A variant whose port configuration equals an earlier
one's prints `same_as` instead of running again.

What does not carry over: the JAX probes' tile_rows of 2048 or 4096 are TPU
tuning; every port kernel uses its 128-row tile (ROADMAP A3), except K8's
probe tile, which score_parity takes as a parameter. precision "bf16" maps
to "default": the JAX package documents the two as bit-identical
(kmersgwas_tpu/ops/score.py:91-96). The port's kernels read (R, W32) rows,
so a probe that timed a transpose to (W32, R) times the port's own layout,
with no transpose. The speeds in the JAX probes' docstrings were measured
on a TPU and are not targets here.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from .. import bench
from ..ops import scanstep as ss
from ..ops import score as score_ops
from ..ops import topk
from ..utils import require_device

N_USED, N_PAD, K, MIN_COUNT, CAND_K = 1008, 1024, 10001, 51, 2048
TILE = 128                      # the port's kernel tile (ops/_cuda.TILE_ROWS)
TIMED = ("latency", "gen", "gen+popcount", "floor", "step", "pieces")


@dataclass(frozen=True)
class Variant:
    probe: str
    name: str
    timed: str
    p: int = 101
    rows: int = 1 << 21
    s: int = 16
    n_warm: int = 1
    n_ramp: int = 8
    n_windows: int = 10
    popcount: str = "fused"     # "fused", "pass" or "none" (bench.make_window)
    cand_w: int | None = None   # step: cand_w mode, else cand_c mode
    cand_c: int | None = None
    cand_c2: int | None = None
    cand_q: int | None = None
    col_group: int = 128
    buf_cap: int | None = None
    precision: str = "default"
    kernel: str | None = None   # floor: the kernel
    thresh: float = 1e30        # floor and pieces: the fixed threshold
    w: int = 256                # floor: score_topw's cand_w, score_parity's w
    tile_rows: int = TILE       # floor: score_parity's probe tile
    piece: int | None = None    # pieces: 0-3
    jax_tile: int | None = None  # the JAX probe's tile_rows (TPU tuning)
    note: str = ""

    def key(self) -> tuple:
        """What runs on the card: equal keys measure the same thing."""
        d = dataclasses.asdict(self)
        for k in ("probe", "name", "n_warm", "n_windows", "jax_tile", "note"):
            del d[k]
        if self.timed != "step":
            del d["n_ramp"]
        return tuple(sorted(d.items()))

    def step_kw(self) -> dict:
        """The scan step's keywords (bench.make_window passes them on)."""
        return dict(cand_w=self.cand_w, cand_k=CAND_K, cand_q=self.cand_q,
                    cand_c=self.cand_c, cand_c2=self.cand_c2,
                    col_group=self.col_group, precision=self.precision)


_R3 = dict(popcount="pass", n_ramp=0, n_windows=1, s=20)
_R3_STEP = dict(_R3, cand_c=256, buf_cap=256 * 24, jax_tile=2048)
_R4 = dict(cand_q=64, n_windows=10, n_ramp=8, jax_tile=2048)
_R4B = dict(cand_c=256, cand_q=64, buf_cap=256 * 24, n_windows=10, n_ramp=8,
            jax_tile=2048)
_PSCALE = dict(cand_c=256, cand_c2=64, cand_q=64, buf_cap=256 * 24,
               n_windows=8, n_ramp=8, jax_tile=2048)
_PCPAD = dict(cand_w=256, cand_q=64, buf_cap=12288, n_windows=12, n_ramp=8,
              jax_tile=4096)
_WIN = dict(popcount="pass", n_ramp=0, n_windows=6)
_WIN2 = dict(popcount="pass", n_ramp=0, n_windows=5, cand_c=256,
             thresh=16000.0, jax_tile=2048)
_EPI = dict(n_windows=12, n_ramp=8, jax_tile=2048)
_TOPW = dict(n_windows=16, n_ramp=12, jax_tile=2048)

VARIANTS = [
    # prof_r3: the pieces of one 2M-row batch (no fused popcount)
    Variant("prof_r3", "latency", "latency",
            note="the relay's dispatch latency -> the card's synced launch "
            "latency: 50 calls of a 1-element add + synchronize"),
    Variant("prof_r3", "gen", "gen+popcount", **_R3),
    Variant("prof_r3", "score", "floor", kernel="score_t", **_R3,
            note="K4 alone; the generator is in every window (prof_r3 `gen`)"),
    Variant("prof_r3", "tilemax", "floor", kernel="score_tilemax",
            thresh=230.0, **_R3),
    Variant("prof_r3", "append", "step", **dict(_R3_STEP, n_ramp=8),
            note="the append path: timed after 8 ramp windows of a fresh "
            "stream (the probe repeated one saturated state on one batch)"),
    Variant("prof_r3", "fallback", "step", **_R3_STEP,
            note="the fallback path: the second window of a fresh stream"),
    Variant("prof_r3", "window8", "step", **dict(_R3_STEP, s=8, n_windows=8)),
    # prof_r4: the cand_c step's generator and candidate width
    Variant("prof_r4", "v0", "step", popcount="pass", cand_c=256,
            buf_cap=256 * 24, **_R4),
    Variant("prof_r4", "v1", "step", cand_c=256, buf_cap=256 * 24, **_R4),
    Variant("prof_r4", "v2", "step", cand_c=256, buf_cap=256 * 24,
            **dict(_R4, jax_tile=4096)),
    Variant("prof_r4", "v3", "step", cand_c=128, buf_cap=128 * 24, **_R4),
    Variant("prof_r4", "v4", "step", cand_c=128, buf_cap=128 * 24,
            **dict(_R4, jax_tile=4096)),
    Variant("prof_r4", "v5", "step", cand_c=256, buf_cap=256 * 24, **_R4,
            note='precision "bf16" -> "default" (bit-identical in the JAX '
            'package)'),
    # prof_r4b: rows per step
    Variant("prof_r4b", "2", "step", rows=1 << 21, s=16, **_R4B),
    Variant("prof_r4b", "4", "step", rows=1 << 22, s=8, **_R4B),
    Variant("prof_r4b", "8", "step", rows=1 << 23, s=4, **_R4B),
    # prof_r5_feed: a small batch
    Variant("prof_r5_feed", "512k", "step", rows=1 << 19, s=32, n_ramp=4,
            n_windows=10, cand_c=128, cand_c2=64, cand_q=64,
            buf_cap=(128 + 2 * 64) * 16, jax_tile=2048),
    # prof_pscale: P, cand_c mode
    *(Variant("prof_pscale", str(p), "step", p=p, **_PSCALE)
      for p in (101, 509, 1013)),
    # prof_r5_pscale: P = 1009, cand_w mode, per-group decisions
    Variant("prof_r5_pscale", "1009", "step", p=1009, rows=1 << 20, s=16,
            n_windows=16, n_ramp=16, cand_w=256, cand_q=64, col_group=128,
            buf_cap=12288, jax_tile=2048),
    # prof_r5_pcpad: P's padding, cand_w mode
    *(Variant("prof_r5_pcpad", str(p), "step", p=p, **_PCPAD)
      for p in (101, 128, 256)),
    # prof_window: the step budget (no fused popcount)
    Variant("prof_window", "w0", "gen", **dict(_WIN, popcount="none")),
    Variant("prof_window", "w1", "gen+popcount", **_WIN,
            note="no transpose: the port's kernels read (R, W32) rows"),
    Variant("prof_window", "w2", "floor", kernel="score_tilemax",
            thresh=8000.0, **_WIN),
    Variant("prof_window", "w3", "step", cand_c=256, buf_cap=256 * 24,
            jax_tile=2048, **dict(_WIN, n_ramp=8),
            note="warm: timed after 8 ramp windows"),
    Variant("prof_window", "w4", "step", cand_c=256, buf_cap=256 * 24,
            jax_tile=2048, **dict(_WIN, n_windows=3),
            note="cold: the windows right after the warm one"),
    # prof_window2: the cand_c step's post-kernel pieces
    *(Variant("prof_window2", f"p{i}", "pieces", piece=i, **_WIN2)
      for i in range(4)),
    # prof_r5_epi: candidate configurations and kernel floors
    Variant("prof_r5_epi", "flag", "step", cand_c=256, cand_c2=64, cand_q=64,
            buf_cap=3072, **_EPI),
    Variant("prof_r5_epi", "floor", "floor", kernel="score_tilemax", **_EPI),
    Variant("prof_r5_epi", "narrow192", "step", cand_c=128, cand_c2=32,
            cand_q=64, buf_cap=1536, **_EPI),
    Variant("prof_r5_epi", "narrow128", "step", cand_c=64, cand_c2=32,
            cand_q=32, buf_cap=1024, **_EPI),
    Variant("prof_r5_epi", "topw128", "step", cand_w=128, cand_q=64,
            buf_cap=2048, **_TOPW),
    Variant("prof_r5_epi", "topw128q32", "step", cand_w=128, cand_q=32,
            buf_cap=2048, **_TOPW),
    Variant("prof_r5_epi", "topw256", "step", cand_w=256, cand_q=64,
            buf_cap=4096, **_TOPW),
    Variant("prof_r5_epi", "topw256big", "step", cand_w=256, cand_q=64,
            buf_cap=12288, **dict(_TOPW, n_windows=24)),
    Variant("prof_r5_epi", "topwfloor", "floor", kernel="score_topw", w=256,
            n_windows=16, n_ramp=8, jax_tile=2048),
    Variant("prof_r5_epi", "rmfloor", "floor", kernel="score_topw", w=256,
            n_windows=12, n_ramp=6, jax_tile=2048,
            note="the replace-min TPU kernel; the port has one K1"),
    Variant("prof_r5_epi", "rm2048", "step", cand_w=256, cand_q=64,
            buf_cap=12288, **dict(_TOPW, n_windows=24)),
    Variant("prof_r5_epi", "rm4096", "step", cand_w=256, cand_q=64,
            buf_cap=12288, **dict(_TOPW, n_windows=24, jax_tile=4096)),
    Variant("prof_r5_epi", "rmfloor4096", "floor", kernel="score_topw", w=256,
            n_windows=16, n_ramp=8, jax_tile=4096),
    Variant("prof_r5_epi", "parity4096", "floor", kernel="score_parity", w=128,
            tile_rows=4096, n_windows=16, n_ramp=8,
            note="K8: two lists of 128 over even and odd 4096-row tiles"),
]
PROBES = tuple(dict.fromkeys(v.probe for v in VARIANTS))
# the variant chip_smoke.py runs of each probe, at reduced window counts
HEADLINE = {"prof_r3": "window8", "prof_r4": "v1", "prof_r4b": "8",
            "prof_r5_feed": "512k", "prof_pscale": "1013",
            "prof_r5_pscale": "1009", "prof_r5_pcpad": "256",
            "prof_window": "w3", "prof_window2": "p3",
            "prof_r5_epi": "parity4096"}


def variant(probe: str, name: str) -> Variant:
    for v in VARIANTS:
        if v.probe == probe and v.name == name:
            return v
    raise KeyError(f"no variant {probe} {name}")


@dataclass
class ProbeRun:
    """A variant's result: its JSON record and, for a step variant, what
    the stream ran (state, phenotypes, generator seed, steps, rows)."""
    record: dict
    state: object = None
    y: np.ndarray | None = None
    seed: int = bench.BENCH_SEED
    steps: int = 0
    rows: int = 0


def _floor_step(v: Variant, yp, ysum, dev):
    """floor: one kernel on the generated batch at a fixed threshold."""
    th = torch.full((v.p,), v.thresh, dtype=torch.float32, device=dev)
    kw = dict(n_used=N_USED, min_count=MIN_COUNT, precision=v.precision)

    def step(state, packed, pc, lo, hi):
        if v.kernel == "score_topw":
            score_ops.score_batch_t_topw(packed, pc, yp, ysum, th,
                                         tile_rows=TILE, cand_w=v.w, **kw)
        elif v.kernel == "score_tilemax":
            score_ops.score_batch_t_tilemax(packed, pc, yp, ysum, th,
                                            tile_rows=TILE, **kw)
        elif v.kernel == "score_t":
            score_ops.score_batch_t(packed, pc, yp, ysum, **kw)
        elif v.kernel == "score_parity":
            score_ops.score_batch_t_parity(packed, pc, yp, ysum, th,
                                           tile_rows=v.tile_rows, w=v.w, **kw)
        else:
            raise ValueError(f"no floor kernel {v.kernel!r}")
    return step


def _pieces_step(v: Variant, yp, ysum, dev):
    """pieces: prof_window2's p0-p3 on the port (K3 at a fixed threshold,
    the top-(c+1) tile maxima, gathers, the two-key sort, the row-id
    gather, the buffered append reset when full)."""
    th = torch.full((v.p,), v.thresh, dtype=torch.float32, device=dev)
    c = v.cand_c
    cap = 3 * c * 8
    buf = dict(v=torch.full((v.p, cap), float("-inf"), device=dev),
               lo=torch.zeros((v.p, cap), dtype=torch.int32, device=dev),
               hi=torch.zeros((v.p, cap), dtype=torch.int32, device=dev),
               n=0)

    def step(state, packed, pc, lo, hi):
        tmax, targ, tmax2, targ2, tmax3, targ3, *_ = \
            score_ops.score_batch_t_tilemax(
                packed, pc, yp, ysum, th, n_used=N_USED,
                min_count=MIN_COUNT, tile_rows=TILE, precision=v.precision)
        v_all, ti = topk.top_k(tmax, c + 1)
        ti_c = ti[:, :c]
        cat_v = torch.cat([v_all[:, :c], tmax2.gather(1, ti_c),
                           tmax3.gather(1, ti_c)], dim=1)
        cat_g = torch.cat([ti_c * TILE + t.gather(1, ti_c)
                           for t in (targ, targ2, targ3)], dim=1).clamp(
                               max=v.rows - 1)
        if v.piece >= 1:
            cat_v, cat_g = topk.sort_desc_index_asc(cat_v, cat_g)
        if v.piece >= 2:
            blo, bhi = lo[cat_g], hi[cat_g]
        if v.piece >= 3:
            n = buf["n"]
            if n + 3 * c <= cap:
                buf["v"][:, n:n + 3 * c] = cat_v
                buf["lo"][:, n:n + 3 * c] = blo
                buf["hi"][:, n:n + 3 * c] = bhi
                buf["n"] = n + 3 * c
            else:
                buf["n"] = 0
    return step


def _latency(dev: torch.device, calls: int = 50) -> dict:
    x = torch.zeros(1, device=dev)
    for _ in range(3):
        x += 1
    bench._sync(dev)
    t0 = time.perf_counter()
    for _ in range(calls):
        x += 1
        bench._sync(dev)
    return {"synced_launch_ms": (time.perf_counter() - t0) / calls * 1e3}


def run_variant(v: Variant, device="cuda", card: str | None = None,
                **counts_kw) -> ProbeRun:
    """Run one variant (window counts may be overridden: n_warm, n_ramp,
    n_windows) and print its JSON line."""
    v = dataclasses.replace(v, **counts_kw) if counts_kw else v
    dev = require_device(device)
    card = card or bench.card_line(dev)
    rec = {"probe": v.probe, "variant": v.name, "timed": v.timed,
           "p": v.p, "rows_per_step": v.rows, "steps_per_window": v.s,
           "config": {k: val for k, val in dataclasses.asdict(v).items()
                      if val is not None and k not in (
                          "probe", "name", "timed", "p", "rows", "s")}}
    if v.timed == "latency":
        rec.update(_latency(dev), device=card)
        print(json.dumps(rec), flush=True)
        return ProbeRun(rec)
    if v.timed not in TIMED:
        raise ValueError(f"unknown timed kind {v.timed!r}")
    rng = np.random.default_rng(0)
    y = rng.normal(size=(N_USED, v.p)).astype(np.float32)
    yp, ysum = score_ops.prepare_phenotypes(y, N_PAD, dev)
    counts = {}
    step, state = None, None
    if v.timed == "step":
        state = ss.init_buffered_state(v.p, K, v.buf_cap, dev)
    elif v.timed == "floor":
        step = _floor_step(v, yp, ysum, dev)
    elif v.timed == "pieces":
        step = _pieces_step(v, yp, ysum, dev)
    else:
        step = lambda *a: None                  # noqa: E731 (gen, gen+pc)
    window = bench.make_window(
        yp, ysum, n_used=N_USED, min_count=MIN_COUNT, rows=v.rows,
        steps=v.s,
        popcount="pass" if v.timed == "gen+popcount" else v.popcount,
        step=step, counts=counts, **v.step_kw())

    def timed_windows(n):
        nonlocal nxt
        out = []
        for _ in range(n):
            t0 = time.perf_counter()
            nxt = window(state, nxt)
            bench._sync(dev)
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    nxt = 0
    warm = timed_windows(v.n_warm)
    ramp = timed_windows(v.n_ramp)
    ramp_counts = dict(counts)
    counts.clear()
    wins = timed_windows(v.n_windows)
    med = statistics.median(wins) / v.s
    rows_s = v.rows / (med * 1e-3)
    rec.update(
        median_step_ms=med, best_step_ms=min(wins) / v.s,
        rows_per_s=rows_s, tests_per_s=rows_s * v.p,
        ms_per_2m_rows=med * (1 << 21) / v.rows,
        warm_window_ms=warm, ramp_window_ms=ramp, window_ms=wins,
        ramp_branches=ramp_counts, branches=dict(counts), steps=nxt,
        device=card)
    if dev.type == "cuda":
        rec["peak_device_gib"] = torch.cuda.max_memory_allocated(dev) / 2**30
    print(json.dumps(rec), flush=True)
    return ProbeRun(rec, state=state, y=y, steps=nxt, rows=v.rows)


def main(probe: str = "all", names=None, device="cuda") -> list[dict]:
    """Run the variants of `probe` (or of every probe: "all"), all of them
    unless `names` are given; one JSON line each."""
    dev = require_device(device)
    card = bench.card_line(dev)
    print(card, file=sys.stderr, flush=True)
    chosen = [v for v in VARIANTS if probe == "all" or v.probe == probe]
    if names:
        chosen = [variant(probe, n) for n in names]
    if not chosen:
        raise ValueError(f"no probe {probe!r}; probes: {PROBES}")
    seen, out = {}, []
    for v in chosen:
        if v.key() in seen:
            rec = {"probe": v.probe, "variant": v.name,
                   "same_as": seen[v.key()], "note": v.note}
            print(json.dumps(rec), flush=True)
        else:
            seen[v.key()] = f"{v.probe} {v.name}"
            if dev.type == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            rec = run_variant(v, dev, card).record
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        out.append(rec)
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m kmersgwas_tpu_torch.tools.probes",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("probe", help=f"one of {', '.join(PROBES)}, or all")
    ap.add_argument("variants", nargs="*", help="variant names (default: "
                    "every variant of the probe)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    if a.probe != "all" and a.probe not in PROBES:
        ap.error(f"unknown probe {a.probe!r}")
    if a.probe == "all" and a.variants:
        ap.error("all takes no variant names")
    main(a.probe, a.variants, device=a.device)


if __name__ == "__main__":
    _cli()
