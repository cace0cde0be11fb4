"""Disk-free streaming scan past 2^31 rows on the card: row-id encode and
decode and checkpoint arithmetic proven end to end at 1001G-like row
counts (port of tools/at_scale_stream.py).

    python -m kmersgwas_tpu_torch.tools.at_scale_stream [--device cuda|cpu]
                                                         [--out PATH]

The scan step of the single-process scan (`scan_step_compact`, `cand_w`
mode: the score_topw kernel on every step) runs over a generated stream
(the gen_planes kernel, seeded per step) of 1104 steps of 2^21 rows,
2,315,255,808 rows (N=1008, P=101, top-10001), with:

  * planted causal rows at ids above 2^31 (carrier patterns correlated
    with phenotype column 0) whose exact 33-bit ids must come out in the
    final top-k of column 0;
  * (lo, hi) row ids carried across the 2^30 encode boundary on the host:
    lo may pass 2^30 inside a batch (the decode hi * 2^30 + lo is exact for
    lo < 2^31) and is normalised after it;
  * a real mid-stream checkpoint (pipeline.checkpoint.save_scan_state after
    window 34 of 69, fingerprinted), then a resume into a fresh state
    seeded as pipeline.scan.associate seeds one (thresh = the k-th score,
    an empty buffer): the resumed run must reproduce the continuous run's
    final top-k (scores and rows) bit for bit, the planted recovery and
    the thresholds.

Each batch is a pure function of (seed, step), so the resume regenerates
the same bytes, as a re-read table gives the real pipeline. The tool's
constants are keyword arguments of `main` (defaults: the JAX tool's), and
`first_row` (default 0) numbers the stream from a later row, so that a
small run can cross 2^31 and the 2^30 split in a few steps. The result
JSON (the JAX tool's keys) goes to `--out` and stdout; a failed check
raises.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from ..ops import _cuda
from ..ops import gen as gen_ops
from ..ops import scanstep as ss
from ..ops import score as score_ops
from ..ops import topk as topk_ops
from ..pipeline import checkpoint as ckpt
from ..utils import require_device

SPLIT = topk_ops._ROW_SPLIT          # 2^30
GEN_SEED = 1_000_003                 # the JAX tool's first generator seed
OUT = os.path.join(_cuda.BUILD, "at_scale_stream_result.json")


def base_of(first_row: int, step: int, rows: int):
    """(lo, hi) of row first_row + step * rows, as the stream carries
    them."""
    r = first_row + step * rows
    return r % SPLIT, r // SPLIT


class Stream:
    """The generated stream with its planted carriers: `run` advances a
    state window by window."""

    def __init__(self, yp, ysum, carrier_words, carrier_pc, planted_ids, *,
                 n_used: int, min_count: int, rows: int,
                 steps_per_window: int, first_row: int, seed: int,
                 cand_w: int, cand_k: int, cand_q: int):
        if not 0 < rows < SPLIT:
            raise ValueError(f"rows ({rows}) must be in (0, 2^30)")
        self.dev = yp.device
        self.yp, self.ysum = yp, ysum
        self.w32 = yp.shape[0] // 32
        self.cw = torch.from_numpy(
            np.ascontiguousarray(carrier_words, np.uint32).view(np.int32)
        ).to(self.dev)
        self.cpc = torch.from_numpy(
            np.asarray(carrier_pc, np.float32)).to(self.dev)
        self.planted = [int(i) for i in planted_ids]
        self.rows, self.S = rows, steps_per_window
        self.first_row, self.seed = first_row, seed
        self.kw = dict(n_used=n_used, min_count=min_count, cand_k=cand_k,
                       tile_rows=_cuda.TILE_ROWS, cand_w=cand_w,
                       cand_q=cand_q)
        self.iota = torch.arange(rows, dtype=torch.int32, device=self.dev)

    def plant(self, packed, pc, lo: int, hi: int) -> None:
        """Write each carrier whose id falls in this batch (rows lo + r,
        hi) over its generated row and popcount, in place."""
        for i, rid in enumerate(self.planted):
            lane = rid - (hi * SPLIT + lo)
            if 0 <= lane < self.rows:
                packed[lane] = self.cw[i]
                pc[lane] = self.cpc[i]

    def run(self, state: ss.BufferedTopKState, from_window: int,
            n_windows: int, label: str, ckpt_at: int | None = None,
            ckpt_path: str | None = None, meta: dict | None = None):
        """Windows from_window .. n_windows-1 on `state` (in place); after
        window `ckpt_at` the flushed state is checkpointed. -> (final
        TopKState, seconds)."""
        rows, S = self.rows, self.S
        lo, hi = base_of(self.first_row, from_window * S, rows)
        t0 = time.perf_counter()
        for w in range(from_window, n_windows):
            for step in range(w * S, (w + 1) * S):
                packed, pc = gen_ops.gen_planes(rows, self.w32, self.seed,
                                                step, self.dev)
                self.plant(packed, pc, lo, hi)
                ss.scan_step_compact(
                    state, packed, pc, self.iota + lo,
                    torch.full((rows,), hi, dtype=torch.int32,
                               device=self.dev),
                    self.yp, self.ysum, **self.kw)
                del packed, pc
                lo += rows
                if lo >= SPLIT:
                    lo, hi = lo - SPLIT, hi + 1
            if w == ckpt_at:
                done = (w + 1) * S * rows
                ckpt.save_scan_state(ckpt_path, ss.flush_buffered(state),
                                     next_row=self.first_row + done,
                                     n_tested=done, stream="stream",
                                     meta=meta)
                print(f"[{label}] checkpoint at window {w} (row "
                      f"{self.first_row + done:,})", file=sys.stderr,
                      flush=True)
            if (w + 1) % 16 == 0:
                print(f"[{label}] window {w + 1}/{n_windows} "
                      f"({(w + 1) * S * rows / 1e9:.2f}B rows, "
                      f"{time.perf_counter() - t0:.0f}s)", file=sys.stderr,
                      flush=True)
        final = ss.flush_buffered(state)
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        return final, time.perf_counter() - t0


def draw(*, seed: int, n_used: int, w32: int, p: int, n_causal: int,
         beta: float, first_row: int, end_row: int):
    """The stream's planted rows and phenotypes, drawn from `seed` as the
    JAX tool draws them: -> (sorted planted ids, all in [max(2^31,
    first_row), end_row); (n_causal, n_used) bool carriers; their
    (n_causal, w32) uint32 words and f32 popcounts; (n_used, p) f32
    phenotypes, column 0 driven by the carriers)."""
    rng = np.random.default_rng(seed)
    # the JAX tool's choice over the id range, without materialising it
    lo_id = max(2**31, first_row)
    causal_ids = np.sort(lo_id + rng.choice(end_row - lo_id, n_causal,
                                            replace=False))
    carriers = rng.random((n_causal, n_used)) < 0.4
    cw = np.zeros((n_causal, w32 * 32), np.uint8)
    cw[:, :n_used] = carriers
    carrier_words = np.packbits(cw, axis=1, bitorder="little").view("<u4")
    carrier_pc = carriers.sum(axis=1).astype(np.float32)
    g = carriers.astype(np.float64)
    y0 = (beta * ((g - g.mean(1, keepdims=True)) / g.std(1, keepdims=True)
                  ).sum(0) + rng.normal(size=n_used))
    y = np.concatenate([y0[:, None], rng.normal(size=(n_used, p - 1))],
                       axis=1).astype(np.float32)
    return causal_ids, carriers, carrier_words, carrier_pc, y


def main(*, n_used: int = 1008, n_pad: int = 1024, p: int = 101,
         k: int = 10001, rows: int = 1 << 21, min_count: int = 51,
         steps_per_window: int = 16, total_steps: int = 1104,
         ckpt_window: int = 34, n_causal: int = 6, beta: float = 3.0,
         first_row: int = 0, seed: int = 7, gen_seed: int = GEN_SEED,
         cand_w: int = 256, cand_k: int = 2048, cand_q: int = 64,
         buf_cap: int = 12288, device="cuda", out: str = OUT) -> dict:
    """Run the stream continuously with a mid-stream checkpoint, resume
    from it, check both, write and return the result JSON. The defaults
    are the JAX tool's (tools/at_scale_stream.py:43-53); the checkpoint
    goes beside `out` (<out without .json>.ckpt.npz)."""
    dev = require_device(device)
    S = steps_per_window
    w32 = n_pad // 32
    total_rows = total_steps * rows
    end_row = first_row + total_rows
    if end_row <= 2**31:
        raise ValueError(f"the stream ends at row {end_row}, not past 2^31")
    if total_steps % S or not 0 <= ckpt_window < total_steps // S - 1:
        raise ValueError("total_steps must be whole windows, with the "
                         "checkpoint before the last")
    causal_ids, carriers, carrier_words, carrier_pc, y = draw(
        seed=seed, n_used=n_used, w32=w32, p=p, n_causal=n_causal, beta=beta,
        first_row=first_row, end_row=end_row)
    yp, ysum = score_ops.prepare_phenotypes(y, n_pad, dev)

    stream = Stream(yp, ysum, carrier_words, carrier_pc, causal_ids,
                    n_used=n_used, min_count=min_count, rows=rows,
                    steps_per_window=S, first_row=first_row, seed=gen_seed,
                    cand_w=cand_w, cand_k=cand_k, cand_q=cand_q)
    n_windows = total_steps // S
    meta = {"total_rows": total_rows, "n_used": n_used,
            "min_count": min_count, "k": k, "p": p}
    ckpt_path = os.path.splitext(out)[0] + ".ckpt"
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)

    print(f"total rows {total_rows:,} from row {first_row:,} (> 2^31 = "
          f"{2**31:,}); planted at " + ", ".join(f"{i:,}" for i in causal_ids),
          file=sys.stderr, flush=True)
    # run A: continuous, with the checkpoint written mid-stream
    final_a, dt_a = stream.run(ss.init_buffered_state(p, k, buf_cap, dev),
                               0, n_windows, "A", ckpt_window, ckpt_path,
                               meta)

    # run B: a fresh state resumed from the checkpoint through the real
    # loader (fingerprint checked), seeded as pipeline.scan.associate seeds
    # a resumed state
    resumed = ckpt.load_scan_state(ckpt_path, meta=meta)
    if resumed is None or resumed[3] != "stream":
        raise RuntimeError(f"no stream checkpoint at {ckpt_path}")
    plain, next_row = resumed[0], resumed[1]
    if next_row != first_row + (ckpt_window + 1) * S * rows:
        raise RuntimeError(f"checkpoint next_row {next_row}")
    st = ss.init_buffered_state(p, k, buf_cap, dev)
    st.scores = torch.from_numpy(plain.scores).to(dev)
    st.row_lo = torch.from_numpy(plain.row_lo).to(dev)
    st.row_hi = torch.from_numpy(plain.row_hi).to(dev)
    st.thresh = st.scores[:, -1].clone()
    final_b, dt_b = stream.run(st, ckpt_window + 1, n_windows, "B")

    ok_equal = all(torch.equal(a, b) for a, b in zip(final_a, final_b))
    rows_a = topk_ops.decode_rows(final_a.row_lo.cpu().numpy(),
                                  final_a.row_hi.cpu().numpy())
    sc_a = final_a.scores.cpu().numpy()
    col0 = set(rows_a[0].tolist())
    recovered = [int(i) for i in causal_ids if int(i) in col0]
    # expected causal scores: an f64 host recompute of the score formula
    n_f = float(n_used)
    y0f = y[:, 0].astype(np.float64)
    n1 = carriers.sum(1).astype(np.float64)
    r_ = n_f * (carriers @ y0f) - n1 * y0f.sum()
    s_exp = r_**2 / (n_f * n1 - n1**2)
    s_got = []
    for rid in causal_ids:
        j = np.flatnonzero(rows_a[0] == rid)
        s_got.append(float(sc_a[0, j[0]]) if len(j) else None)
    score_ok = all(v is not None and abs(v - e) / e < 5e-3
                   for v, e in zip(s_got, s_exp))
    max_row_seen = int(rows_a.max())

    result = {
        "total_rows": total_rows,
        "first_row": first_row,
        "planted_ids": [int(i) for i in causal_ids],
        "recovered": recovered,
        "n_recovered": len(recovered),
        "planted_scores_match_host_f64": bool(score_ok),
        "resume_bit_exact": bool(ok_equal),
        "max_row_id_in_topk": max_row_seen,
        "max_row_exceeds_2p31": bool(max_row_seen > 2**31),
        "threshold_col0": float(sc_a[0, -1]),
        "wall_seconds_continuous": round(dt_a, 1),
        "wall_seconds_resumed_half": round(dt_b, 1),
        "rows_per_sec_continuous": round(total_rows / dt_a, 1),
    }
    with open(out, "w") as f:
        json.dump(result, f, indent=2)
    print(json.dumps(result), flush=True)
    if not ok_equal:
        raise RuntimeError("resume did not reproduce the continuous run")
    if len(recovered) != n_causal:
        raise RuntimeError(f"recovered {recovered} of {list(causal_ids)}")
    if not score_ok:
        raise RuntimeError(f"planted scores {s_got} != f64 {list(s_exp)}")
    return result


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m kmersgwas_tpu_torch.tools.at_scale_stream",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the stream runs (cuda raises without a "
                         "card)")
    ap.add_argument("--out", default=OUT, help="result JSON path")
    a = ap.parse_args(argv)
    main(device=a.device, out=a.out)


if __name__ == "__main__":
    _cli()
