#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (kmersgwas_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. environment: the card's name and power limit, CUDA and nvcc versions,
     the kernels' build from csrc/;
  2. kernels against their plain PyTorch versions on the card, at a small
     shape and at one flagship batch (R=2,097,152, N=1008, P=101, W=256):
     bit-equal on dyadic phenotypes, within a stated tolerance on Gaussian
     ones at precision "highest", with times;
  3. the main path, `associate` on the dtable route at its real shape
     (N=1008, P=101, top-10001, 2,000,000-row batches, ~4.2M rows), held
     against a numpy f64 brute force;
  4. the scan step's settled regime at the same shape: 85 device-made
     2M-row batches through `scan_step_compact` (the append branch engages
     once the threshold settles), held bit for bit against a plain running
     top-k, with step times and a profiled window of settled steps;
  5. the CLI, `associate --device cuda` against `--device cpu`: output
     files byte-identical.
The script writes its inputs itself and imports nothing of the JAX
package. The line before the last is the kernels' JSON record; the last
line is {"ok": true, "device": {...}}. Without CUDA the script fails at
once.
"""
import json
import os
import shutil
import statistics
import struct
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
TOPW_SOURCE = "kmersgwas_tpu_torch/csrc/score_topw.cu"
BMAX_SOURCE = "kmersgwas_tpu_torch/csrc/score_bmax.cu"
TOPW_REPLACES = "kmersgwas_tpu/ops/score.py:448"
BMAX_REPLACES = "kmersgwas_tpu/ops/score.py:178"
# Gaussian phenotypes at precision "highest": the kernel and cuBLAS sum
# ~500 f32 terms in different orders, and the score's numerator N*yigi -
# n1*ysum cancels, so an error in r of a few f32 ulps of N*yigi moves a
# score s by ~2*sqrt(s/denom)*dr: relative on large scores, and bounded by
# the column's largest score near zero. Bound: |d| <= RTOL*(|s| + max|s|).
RTOL = 1e-5


class PhaseError(RuntimeError):
    pass


def need(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(msg=""):
    print(msg, flush=True)


def dyadic(rng, shape):
    """Multiples of 1/8 in [-8, 8]: exact in bf16 and in any f32 sum order
    at these sizes, so kernel and plain scores must agree bit for bit."""
    return (np.round(rng.uniform(-8, 8, size=shape) * 8) / 8).astype(
        np.float32)


def col_scale(sc):
    """(P, 1) largest finite |score| of each column."""
    import torch
    return torch.where(torch.isfinite(sc), sc.abs(), 0.0).amax(
        dim=1, keepdim=True)


def cuda_ms(fn, reps=5):
    """Median device time of fn() over `reps` runs, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


# ---------------------------------------------------------------- phase 1

def phase_env():
    import torch
    from kmersgwas_tpu_torch.ops import _cuda
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    lib = _cuda.library()
    log(f"nvcc: {lib.nvcc_version}")
    log(f"kernels: {os.path.relpath(lib.path, ROOT)} built in "
        f"{lib.build_seconds if lib.build_seconds is not None else 0:.1f} s"
        f" (load {time.perf_counter() - t0:.1f} s)")
    for ln in lib.log.splitlines():
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln:
            log("  ptxas: " + ln.strip())
    return card


# ---------------------------------------------------------------- phase 2

def make_planes(rows, n, seed, pad_rows=0):
    """Random packed planes on the card (bits past n zero, the last
    `pad_rows` rows zero = padding) and their popcounts."""
    import torch
    from kmersgwas_tpu_torch.ops import bitplanes
    n_pad = -(-n // 128) * 128
    w32 = n_pad // 32
    g = torch.Generator(device="cuda").manual_seed(seed)
    packed = torch.randint(-2 ** 31, 2 ** 31, (rows, w32), dtype=torch.int32,
                           device="cuda", generator=g)
    lane_ok = np.zeros(n_pad, np.uint8)
    lane_ok[:n] = 1
    mask = torch.from_numpy(
        bitplanes.pack_bits_np(lane_ok).view(np.int32)).cuda()
    packed &= mask
    if pad_rows:
        packed[rows - pad_rows:] = 0
    return packed, bitplanes.popcount_rows(packed)


def make_batch(rows, n, p, seed, pad_rows, gaussian):
    """make_planes plus phenotypes (padded y and column sums)."""
    from kmersgwas_tpu_torch.ops import score
    packed, popcnt = make_planes(rows, n, seed, pad_rows)
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(n, p)).astype(np.float32) if gaussian
         else dyadic(rng, (n, p)))
    yp, ysum = score.prepare_phenotypes(y, -(-n // 128) * 128, "cuda")
    return packed, popcnt, yp, ysum


def check_kernels_at(rows, n, p, w, seed, label, timing=False):
    """K1 and K2 against their plain versions at one shape. Returns
    (max abs err K1, max abs err K2, times or None)."""
    import torch
    from kmersgwas_tpu_torch.ops import score
    mc = 5
    kw = dict(n_used=n, min_count=mc)
    err1 = err2 = 0.0
    times = None
    for gaussian, prec in ((False, "default"), (False, "highest"),
                           (True, "highest")):
        packed, pc, yp, ysum = make_batch(rows, n, p, seed, rows // 8 + 37,
                                          gaussian)
        ks, kb = score.score_batch_t_bmax(packed, pc, yp, ysum,
                                          precision=prec, **kw)
        torch.cuda.synchronize()
        ps, pb = score.scores_and_bmax_plain(packed, pc, yp, ysum,
                                             precision=prec, **kw)
        need(ks.shape == ps.shape and kb.shape == pb.shape,
             f"{label}: bmax shapes {ks.shape} {kb.shape}")
        fin = torch.isfinite(ps)
        need(torch.equal(torch.isfinite(ks), fin), f"{label}: -inf lanes")
        if gaussian:
            d = torch.where(fin, (ks - ps).abs(), 0.0)
            err2 = max(err2, float(d.max()))
            need(bool((d <= RTOL * (torch.where(fin, ps.abs(), 0.0)
                                    + col_scale(ps))).all()),
                 f"{label}: K2 gaussian scores off by {float(d.max())}")
        else:
            need(torch.equal(ks, ps) and torch.equal(kb, pb),
                 f"{label}: K2 != plain ({prec}, dyadic), max diff "
                 f"{float((ks[fin] - ps[fin]).abs().max())}")
        kth = max(1, min(100, rows // 64))
        q = torch.topk(ps, kth, dim=1).values[:, -1].contiguous()
        for th_name, th in (("-inf", torch.full((p,), float("-inf"),
                                                device="cuda")),
                            ("quantile", q),
                            ("+inf", torch.full((p,), float("inf"),
                                                device="cuda"))):
            args = (packed, pc, yp, ysum, th)
            tkw = dict(tile_rows=128, cand_w=w, precision=prec, **kw)
            kv, kg, kok = score.score_batch_t_topw(*args, **tkw)
            torch.cuda.synchronize()
            pv, pg, pok = score.topw_plain(*args, **tkw)
            if gaussian:
                fv = torch.isfinite(pv)
                need(torch.equal(torch.isfinite(kv), fv),
                     f"{label}: K1 -inf slots differ")
                d = torch.where(fv, (kv - pv).abs(), 0.0)
                if d.numel():
                    err1 = max(err1, float(d.max()))
                    need(bool((d <= RTOL * (torch.where(fv, pv.abs(), 0.0)
                                            + col_scale(ps))).all()),
                         f"{label}: K1 gaussian values off by "
                         f"{float(d.max())}")
            else:
                need(torch.equal(kv, pv) and torch.equal(kg, pg)
                     and torch.equal(kok, pok),
                     f"{label}: K1 != plain ({prec}, dyadic, th {th_name})")
            # ok (with the caller's W-th <= thresh check) is conservative:
            # every lane scoring > thresh is in the list, with its score
            ok_eff = kok & (kv[:, -1] <= th)
            for c in torch.nonzero(ok_eff).flatten().tolist():
                hot = torch.nonzero(ks[c] > th[c]).flatten()
                pos = torch.isin(hot, kg[c])
                need(bool(pos.all()), f"{label}: column {c} ok but a hot "
                     f"lane is missing (th {th_name})")
            if timing and not gaussian and prec == "default" \
                    and th_name == "quantile":
                t_k1 = cuda_ms(lambda: score.score_batch_t_topw(*args,
                                                                **tkw))
                t_p1 = cuda_ms(lambda: score.topw_plain(*args, **tkw),
                               reps=3)
                t_k2 = cuda_ms(lambda: score.score_batch_t_bmax(
                    packed, pc, yp, ysum, precision=prec, **kw))
                t_p2 = cuda_ms(lambda: score.scores_and_bmax_plain(
                    packed, pc, yp, ysum, precision=prec, **kw), reps=3)
                times = (t_k1, t_p1, t_k2, t_p2)
            log(f"  {label} {'gauss' if gaussian else 'dyadic'} {prec:8s} "
                f"th={th_name:8s}: K1 ok cols {int(kok.sum())}/{p}, "
                f"ok_eff {int(ok_eff.sum())}")
        del ks, kb, ps, pb
        torch.cuda.empty_cache()
    return err1, err2, times


def phase_kernels():
    """-> the largest errors measured over every shape (Gaussian phenotypes
    at "highest"; dyadic ones are checked bit-equal) and the flagship
    times."""
    e1 = e2 = 0.0
    for rows, n, p, w in ((1024, 100, 3, 16), (1024, 100, 70, 256),
                          (4096, 1008, 101, 256)):
        a, b, _ = check_kernels_at(rows, n, p, w, seed=rows + p,
                                   label=f"R={rows} N={n} P={p} W={w}")
        e1, e2 = max(e1, a), max(e2, b)
    a, b, times = check_kernels_at(2_097_152, 1008, 101, 256, seed=7,
                                   label="flagship", timing=True)
    e1, e2 = max(e1, a), max(e2, b)
    log(f"flagship K1 score_topw: kernel {times[0]:.3f} ms, plain "
        f"{times[1]:.3f} ms; K2 score_bmax: kernel {times[2]:.3f} ms, plain "
        f"{times[3]:.3f} ms (median CUDA-event times)")
    log(f"max abs err over all shapes (gaussian, highest): K1 {e1:.3g}, "
        f"K2 {e2:.3g}")
    return dict(err1=e1, err2=e2, times=times)


# ---------------------------------------------------------------- phase 3

_BYTE_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                               axis=1).sum(axis=1).astype(np.uint8)


# the .table header: magic, accession count, k-mer length (little endian)
TABLE_HEADER = struct.Struct("<IQI")
TABLE_MAGIC = 0xDDCCBBAA


def write_table(base, n, n_rows, kmer_len, seed):
    """Synthetic .table and .names (the layout bench.py:34-64 writes, with
    every file bit past n zero) -> (names, popcount of every row)."""
    names = [f"acc{i}" for i in range(n)]
    wf = (n + 63) // 64
    tail_mask = np.uint64((1 << (n - 64 * (wf - 1))) - 1) if n % 64 \
        else np.uint64(2 ** 64 - 1)
    rng = np.random.default_rng(seed)
    pcs = []
    with open(base + ".table", "wb") as f:
        f.write(TABLE_HEADER.pack(TABLE_MAGIC, n, kmer_len))
        chunk = 1 << 20
        for s in range(0, n_rows, chunk):
            m = min(chunk, n_rows - s)
            rows = np.empty((m, 1 + wf), dtype="<u8")
            rows[:, 0] = np.arange(s, s + m, dtype=np.uint64) * np.uint64(97)
            rows[:, 1:] = rng.integers(0, 2 ** 64 - 1, size=(m, wf),
                                       dtype=np.uint64, endpoint=True)
            rows[:, wf] &= tail_mask
            pcs.append(_BYTE_POPCOUNT[rows[:, 1:].view(np.uint8)].sum(
                axis=1, dtype=np.int64))
            rows.tofile(f)
    with open(base + ".names", "w") as f:
        f.write("".join(f"{a}\n" for a in names))
    return names, np.concatenate(pcs)


def write_phenotypes(path, names, accessions, values):
    """Phenotype TSV: `accession_id<TAB>name...` then one row per
    accession, values in %g (exact for dyadic values)."""
    with open(path, "w") as f:
        f.write("accession_id\t" + "\t".join(names) + "\n")
        for acc, row in zip(accessions, values):
            f.write(acc + "\t" + "\t".join("%g" % v for v in row) + "\n")


def oracle_top(base, n, y_cols, keep, k, chunk=1 << 16):
    """numpy f64 brute force: per column, the top-k table rows by (exact
    score desc, row asc) among MAC-passing rows, with their scores."""
    wf = (n + 63) // 64
    raw = np.memmap(base + ".table", dtype="<u8", mode="r",
                    offset=TABLE_HEADER.size).reshape(-1, 1 + wf)
    y = y_cols.astype(np.float64)
    ysum = y.sum(axis=0)
    best = [(np.empty(0), np.empty(0, np.int64))] * y.shape[1]
    for s in range(0, raw.shape[0], chunk):
        blk = np.ascontiguousarray(raw[s:s + chunk, 1:])
        bits = np.unpackbits(blk.view(np.uint8), axis=1,
                             bitorder="little")[:, :n].astype(np.float64)
        n1 = bits.sum(axis=1)
        r = n * (bits @ y) - n1[:, None] * ysum[None, :]
        denom = (n * n1 - n1 * n1)[:, None]
        with np.errstate(divide="ignore", invalid="ignore"):
            sc = np.where(denom > 0, r * r / denom, 0.0)
        rows = np.arange(s, s + len(blk))
        kk = keep[s:s + len(blk)]
        for j in range(y.shape[1]):
            v = np.concatenate([best[j][0], sc[kk, j]])
            rw = np.concatenate([best[j][1], rows[kk]])
            o = np.lexsort((rw, -v))[:k]
            best[j] = (v[o], rw[o])
    return best


def phase_main(workdir, n_rows=4_200_000, p=101, k=10001, batch=2_000_000,
               device="cuda"):
    """The main path at its real shape (the defaults); smaller arguments
    and device="cpu" rehearse the phase without a card."""
    import torch
    from kmersgwas_tpu_torch.core import dtable as dt_mod
    from kmersgwas_tpu_torch.ops import score
    from kmersgwas_tpu_torch.pipeline import scan
    n, kmer_len = 1008, 31
    cuda = device == "cuda"
    base = os.path.join(workdir, "pop")
    t0 = time.perf_counter()
    names, pcs = write_table(base, n, n_rows, kmer_len, seed=1)
    min_count = scan.effective_min_count(n, 0.05, 5)
    keep = (pcs >= min_count) & (pcs <= n - min_count)
    dtable = base + ".dtable"
    dt_mod.build_dtable(base, dtable, names_to_use=names,
                        min_count=min_count, batch_rows=1 << 18)
    log(f"main: table {n_rows} rows x N={n} written and dtable built in "
        f"{time.perf_counter() - t0:.1f} s ({int(keep.sum())} rows pass "
        f"MAC >= {min_count})")
    y = np.random.default_rng(2).normal(size=(n, p)).astype(np.float32)
    cols = [f"p{j}" for j in range(p)]

    score.score_batch_t_topw.launches = 0
    score.score_batch_t_bmax.launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    res = scan.associate(base, names, y, cols, kmer_len=kmer_len,
                         device=device, dtable_cache=dtable, n_top=k,
                         batch_size=batch, certify_topk=True,
                         progress=lambda r: None)
    wall = time.perf_counter() - t0
    k1 = score.score_batch_t_topw.launches
    k2 = score.score_batch_t_bmax.launches
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_batches = -(-int(keep.sum()) // batch)
    st = res.steps
    log(f"main: associate wall {wall:.2f} s, timings "
        + json.dumps({a: round(b, 4) for a, b in res.timings.items()}))
    log(f"main: {res.n_tested} k-mers, {res.n_tested / res.timings['stream']:,.0f} "
        f"k-mers/s over the stream; step ms "
        f"{[round(1e3 * s, 2) for s in st['step_s']]} (median "
        f"{1e3 * statistics.median(st['step_s']):.2f}); narrow {st['narrow']}"
        f" wide {st['wide']} fallback {st['fallback']} flush {st['flush']}")
    log(f"main: K1 score_topw launches {k1}, K2 score_bmax launches {k2}, "
        f"{n_batches} batches, peak device memory {peak / 2**30:.2f} GiB")
    need(res.n_tested == int(keep.sum()),
         f"n_tested {res.n_tested} != MAC-passing rows {int(keep.sum())}")
    need(k1 >= n_batches or not cuda,
         f"K1 launched {k1} times for {n_batches} batches")
    # the first batch always falls back: the threshold starts at -inf
    need(k2 >= 1 or not cuda, "K2 was never launched on the main path")
    need(res.certified is not None and all(res.certified),
         f"certified {sum(res.certified or [])}/{p} columns")
    t0 = time.perf_counter()
    check_cols = (0, p // 2, p - 1)
    best = oracle_top(base, n, y[:, check_cols], keep, k)
    for j, (bv, br) in zip(check_cols, best):
        need(np.array_equal(res.rows[j], br),
             f"column {j}: rows differ from the f64 oracle "
             f"({np.sum(res.rows[j] != br)} of {k})")
        need(np.allclose(res.scores[j], bv, rtol=1e-12, atol=0),
             f"column {j}: certified scores differ from the f64 oracle")
    log(f"main: all {p} columns certified; columns {list(check_cols)} equal "
        f"the f64 oracle's top-{k} (oracle {time.perf_counter() - t0:.1f} s)")
    return dict(k1=k1, k2=k2)


# ---------------------------------------------------------------- phase 4

def device_busy(prof):
    """(summed device time of every kernel and copy in ms, the three
    largest (name, ms)) of a torch.profiler run."""
    per = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", None)
        if t is None:
            t = e.self_cuda_time_total
        if t > 0:
            per[e.key] = per.get(e.key, 0.0) + t / 1e3
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    return sum(per.values()), top


def phase_stream(n_batches=80, n_prof=5, rows=2_000_000, n=1008, p=101,
                 k=10001 + 1024):
    """The scan step's settled regime at the main path's shape (N=1008,
    P=101, top-10001 + the certify band, 2,000,000-row batches): device-
    made batches through scan_step_compact with the scan's parameters, so
    K1 runs on every batch, K2 on the threshold ramp's fallbacks and the
    append branch once the threshold settles. Dyadic phenotypes at
    precision "default" make kernel and plain scores bit-equal, so the
    final top-k must equal, scores and rows, a plain running top-k (plain
    scores, one stable sort per batch, earlier rows first on ties). The
    last n_prof steps run under torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kmersgwas_tpu_torch.ops import scanstep as ss
    from kmersgwas_tpu_torch.ops import score, topk
    from kmersgwas_tpu_torch.pipeline import scan
    min_count = scan.effective_min_count(n, 0.05, 5)
    y = dyadic(np.random.default_rng(11), (n, p))
    yp, ysum = score.prepare_phenotypes(y, -(-n // 128) * 128, "cuda")
    state = ss.init_buffered_state(p, k, scan.BUF_CAP, "cuda")
    counts = {}
    kw = dict(n_used=n, min_count=min_count, cand_k=min(max(256, k // 8), k),
              tile_rows=scan.TILE_ROWS, cand_w=scan.CAND_W,
              cand_q=scan.CAND_Q, precision="default", counts=counts)
    ov = torch.full((p, k), float("-inf"), device="cuda")
    orow = torch.zeros((p, k), dtype=torch.int64, device="cuda")

    def batch(b):
        packed, pc = make_planes(rows, n, seed=1000 + b)
        lo = torch.arange(b * rows, (b + 1) * rows, dtype=torch.int32,
                          device="cuda")           # rows < 2^30: hi is 0
        return packed, pc, lo, torch.zeros_like(lo)

    def oracle(b, packed, pc):
        nonlocal ov, orow
        sc = score.scores_t_plain(packed, pc, yp, ysum, n_used=n,
                                  min_count=min_count, precision="default")
        v, j = torch.sort(torch.cat([ov, sc], dim=1), dim=1,
                          descending=True, stable=True)
        j = j[:, :k]
        orow = torch.where(j < k, orow.gather(1, j.clamp(max=k - 1)),
                           b * rows + j - k)
        ov = v[:, :k].contiguous()

    step_ms = {"append": [], "fallback": []}
    t0 = time.perf_counter()
    for b in range(n_batches):
        args = batch(b)
        before = counts.get("fallback", 0)
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        ss.scan_step_compact(state, *args, yp, ysum, **kw)
        torch.cuda.synchronize()
        step_ms["fallback" if counts.get("fallback", 0) > before
                else "append"].append(1e3 * (time.perf_counter() - t_step))
        oracle(b, *args[:2])
    prof_args = [batch(b) for b in range(n_batches, n_batches + n_prof)]
    before = dict(counts)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t_prof = time.perf_counter()
        for args in prof_args:
            ss.scan_step_compact(state, *args, yp, ysum, **kw)
        torch.cuda.synchronize()
        wall_prof = 1e3 * (time.perf_counter() - t_prof)
    prof_kinds = {a: counts.get(a, 0) - before.get(a, 0)
                  for a in ("narrow", "wide", "fallback", "flush")}
    for b, args in enumerate(prof_args, start=n_batches):
        oracle(b, *args[:2])
    final = ss.flush_buffered(state)
    got_rows = topk.decode_rows(final.row_lo.cpu().numpy(),
                                final.row_hi.cpu().numpy())
    log(f"stream: {n_batches + n_prof} batches of {rows} rows, N={n} P={p} "
        f"k={k} in {time.perf_counter() - t0:.1f} s; branches {counts}")
    for kind, ms in step_ms.items():
        if ms:
            log(f"stream: {kind} step ms median {statistics.median(ms):.2f} "
                f"over {len(ms)} steps (first {ms[0]:.2f}, last {ms[-1]:.2f};"
                f" each step synchronized at its end)")
    busy, top = device_busy(prof)
    log(f"stream: profiled {n_prof} steps {prof_kinds}: wall "
        f"{wall_prof:.2f} ms, device busy {busy:.2f} ms ("
        + (f"idle {100 * (1 - busy / wall_prof):.1f} %); top kernels "
           + ", ".join(f"{nm[:48]} {t:.3f} ms" for nm, t in top)
           if busy > 0 else "no device time in the trace: not measured)"))
    need(counts.get("narrow", 0) + counts.get("wide", 0) >= 10,
         f"the append branch ran only {counts} times")
    need(counts.get("fallback", 0) >= 1, f"no fallback step: {counts}")
    need(torch.equal(final.scores, ov),
         "stream: final scores differ from the plain running top-k")
    need(np.array_equal(got_rows, orow.cpu().numpy()),
         "stream: final rows differ from the plain running top-k")
    log(f"stream: final top-{k} of all {p} columns equal the plain running "
        f"top-k (scores and rows)")


# ---------------------------------------------------------------- phase 5

def phase_cli(workdir, devices=("cuda", "cpu")):
    base = os.path.join(workdir, "small")
    n = 200
    names, _ = write_table(base, n, 20_000, 31, seed=3)
    y = dyadic(np.random.default_rng(4), (n, 3))
    pheno = os.path.join(workdir, "small.pheno")
    write_phenotypes(pheno, ["a", "b", "c"], names, y)
    outs = {}
    for i, dev in enumerate(devices):
        out = os.path.join(workdir, f"cli_{i}_{dev}")
        os.makedirs(out)
        cmd = [sys.executable, "-m", "kmersgwas_tpu_torch.cli", "associate",
               "-p", pheno, "-b", "small", "-o", out, "--kmers_table", base,
               "-n", "100", "--batch_size", "4096", "--kmer_len", "31",
               "--pattern_counter", "--device", dev,
               "--dtable_cache", os.path.join(workdir, f"small_{i}.dtable")]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        need(proc.returncode == 0,
             f"cli --device {dev} failed:\n{proc.stdout}\n{proc.stderr}")
        log(f"cli --device {dev}: {proc.stdout.strip()} "
            f"({time.perf_counter() - t0:.1f} s)")
        outs[i] = {f: open(os.path.join(out, f), "rb").read()
                     for f in sorted(os.listdir(out))}
    a, b = outs[0], outs[1]
    need(sorted(a) == sorted(b),
         f"cli outputs differ in files: {sorted(a)} vs {sorted(b)}")
    diff = [f for f in a if a[f] != b[f]]
    need(not diff, f"cli outputs differ: {diff}")
    need(any(f.endswith(".bed") for f in a), "no bed output")
    log(f"cli: {len(a)} output files byte-identical between "
        f"--device {devices[0]} and --device {devices[1]}")


# ---------------------------------------------------------------- main

def main():
    try:
        import torch
    except ImportError:
        print("FAIL: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False: this script "
              "runs only on the card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    try:
        import kmersgwas_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"FAIL: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 1
    build = os.path.join(ROOT, "kmersgwas_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="smoke_", dir=build)
    try:
        phase_env()
        kres = phase_kernels()
        mres = phase_main(workdir)
        phase_stream()
        phase_cli(workdir)
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "jax" in sys.modules:
        print("FAIL: jax was imported", file=sys.stderr)
        return 1
    t = kres["times"]
    log(json.dumps({"kernels": [
        {"name": "score_topw", "route": "cuda", "source": TOPW_SOURCE,
         "replaces": TOPW_REPLACES, "launches": mres["k1"],
         "max_abs_err": kres["err1"], "ms": t[0], "plain_ms": t[1]},
        {"name": "score_bmax", "route": "cuda", "source": BMAX_SOURCE,
         "replaces": BMAX_REPLACES, "launches": mres["k2"],
         "max_abs_err": kres["err2"], "ms": t[2], "plain_ms": t[3]},
    ]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
