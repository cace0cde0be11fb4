#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (kmersgwas_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):
  1. environment: the card's name and power limit, CUDA and nvcc versions,
     the kernels' build from csrc/ (one nvcc per source, in parallel), the
     ptxas lines of every kernel (K6's and K9's instances one line each
     kernel or float4 count; none may spill or keep a stack frame), and
     K6's integer floor from the SASS of its built kernel (cuobjdump);
  2. kernels against their plain PyTorch versions on the card, at small
     shapes (P up to 1013, eight column chunks of the tensor-core body) and
     at one flagship batch (R=2,097,152, N=1008, P=101, W=256): K1-K5
     bit-equal on dyadic phenotypes, within a stated tolerance on Gaussian
     ones at precision "highest", with times. Every score kernel runs on
     the tensor-core body (csrc/score_wgmma.cuh): K1 (score_topw), K3
     (score_tilemax), and the score plane's three modes
     (csrc/score_plane.cu): K2 (score_bmax) and K4 (score_t) through its
     bulk-copy epilogue, K5 (score_rows) through its row-major one. K2's
     scores equal K1's values at K1's lanes at every shape, and on the
     flagship at both precisions on Gaussian and dyadic phenotypes; there
     K5's scores also equal K4's, transposed, with -inf as 0. K3 also on
     batches with runs of equal rows inside tiles (tied 2nd/3rd values),
     its tiles' top 3 equal to K1's list on Gaussian ones; K1's tile and
     select launches, K2's, K4's and K5's kernels apart from their operand
     build (profiler), and K3, at both precisions, beside a GEMM-only
     yardstick (a bf16 torch.matmul of the pre-unpacked bits, which
     computes no score); K7 (kinship_accumulate: the bit transpose, then
     the int8 wgmma Gram) bit-equal to the plain +-1 Gram at 2^20 rows x
     N=1008, also at a ragged n_rows (2^20 - 37) with a random tail, its
     transpose equal to the plain one, with the call's time and each
     kernel's by the profiler beside a product-only yardstick
     (torch._int_mm of the unpacked +-1 operand, the full Gram);
  3. the main path, `associate` on the dtable route at its real shape
     (N=1008, P=101, top-10001, 2,000,000-row batches, ~4.2M rows), held
     against a numpy f64 brute force;
  4. the scan step's settled regime at the same shape: device-made 2M-row
     batches through `scan_step_compact` (the append branch engages once
     the threshold settles), held bit for bit against a plain running
     top-k, with step times, a profiled window of settled steps and one
     of 5 fallback steps from the ramp (device time split into K2's
     kernel, its operand build, top_k_from_bmax, the rest of
     _flush_merge, the candidate kernel and the rest); 85 batches in
     `cand_w` mode (the single-process scan's step, K1), 245 in `cand_c`
     mode with the multi-process driver's parameters (K3);
  5. the CLI, `associate --device cuda` against `--device cpu`: output
     files byte-identical;
  6. the multi-process scan's path, `run_distributed_scan` in one process
     on phase 3's table (N=1008, P=101, top-10001, 2M-row batches): the
     same top-k as `associate` in all 101 columns, K3 on every batch;
  7. `associate-mp` in 2 processes sharing the card (gloo) against 1
     process, both runs at once: output files byte-identical;
  8. the kinship path, `kinship_from_table` on phase 3's table (N=1008,
     4.2M rows, maf 0.05, 2^20-row batches, K7 on every batch) on both
     routes: equal to the plain accumulator on the card bit for bit, to a
     numpy XNOR count on 64 sampled pairs, and to a run resumed from its
     mid-stream checkpoint; rows/s and peak device memory; another run
     under the profiler, synchronized at its end (per full batch of that
     whole run: K7's share of the wall and of the device time, the idle
     share, which must lie in [0, 100] %; the device's batch ends by CUDA
     events) and the host feed's rate alone;
  9. `kinship --device cuda` against `--device cpu` on a 200,000-row
     N=200 table: stdout byte-identical;
 10. `kinship-mp` in 2 processes sharing the card against phase 8's
     one-process matrix: `write_kinship`'s TSV byte-identical;
 11. (none: the phases after it keep their numbers);
 12. `score_batch` (K5, the score plane's row-major mode) on one flagship
     batch against a numpy f64 computation on sampled rows;
 13. K6 (gen_planes) against its plain version at (2^21, 32) for two
     (seed, step) pairs and at a ragged 2^21 - 37 rows: planes and
     popcounts bit-equal, the popcounts equal to a bit count of the
     planes, consecutive steps different, every bit position's density
     0.5 +- 2e-3; times of both, and the kernel alone by the profiler
     (in a new process);
 14. the port's bench, `bench.main()` at its defaults (30 windows of 16
     generated 2^21-row steps after the adaptive ramp; the host feed
     measured on a 4.2M-row synthetic table in the work directory), then
     `bench.streaming` and `bench.kinship_streaming` on that table: K6 on
     every step, K1 at least as often, a finite checksum, and every kept
     row of column 0, regenerated alone by the plain generator and
     re-scored in f64, within CERTIFY_EPS of its kept score;
 15. the at-scale stream at full size (1104 steps of 2^21 rows,
     2,315,255,808 rows): the 6 planted ids above 2^31 recovered with their
     f64 scores, the resume from the mid-stream checkpoint bit-exact, the
     top-k's largest id past 2^31;
 16. the probes' kernels: the exp_kernel tool's twenty cases (K9,
     tile_reduce and tile_topc) at the probe's shape (P_PAD 104, NT 128,
     TR 2048) on its tie-heavy plane, each bit-equal to its plain version
     and to the JAX kernel's function in numpy; K8 (score_parity) on one
     flagship batch (R=2,097,152, N=1008, P=101, tile 4096, w 128)
     bit-equal to parity_plain on dyadic phenotypes and within RTOL on
     Gaussian ones at "highest"; K6 at every probe generator's shape
     (2^19-2^23 rows), popcounts on and off, bit-equal to plain; times
     (tile_reduce's, tile_topc's and K6's kernels at those shapes also by
     the profiler, in a new process, beside their whole calls; the
     yardsticks torch.max(dim=2) and torch.sort(stable));
 17. each probe's headline variant through the probe tool, window counts
     cut: K6 on every step, K8 on every step of prof_r5_epi parity4096,
     the step's branch counts; prof_r5_pscale at P=1009 with col_group 128,
     the kept rows of columns 0 and 1008 regenerated alone and re-scored
     in f64 on the phenotypes the GEMM multiplies (bf16 at "default"),
     within CERTIFY_EPS;
 18. the gwas path, `run_gwas` at the flagship on phase 3's table (N=1008,
     ~4.2M rows, k=31): one Gaussian phenotype with 8 accessions given
     twice (averaged), 100 permutations, top-10001, 2M-row batches,
     kinship from the table (K7), the scan (K1, K2) with certify_topk,
     once with the exact LMM's device32 backend and once with host64
     (float64 on the card); kinship equal to phase 8's bit for bit, the
     transform to a numpy Cholesky solve, three columns' top-k to the f64
     oracle, host64 p-values of 3 x 32 candidates to a scipy oracle,
     device32 to host64, the thresholds to the order statistic of
     best_pvals, the pass files to the assoc table; stage seconds of both
     runs. Then `gwas --device cuda` against `--device cpu` on phase 5's
     table: artifacts byte-identical, full floats within rtol 1e-9;
 19. the SNP arm at a real size (phase_snps): a synthetic bed of 2^20
     SNPs over phase 3's 1008 accessions (MAF uniform in [0.01, 0.5], 2 %
     het, 5 % missing, one planted causal SNP), made on the card;
     emma_kinship_from_bed against a float64 recomputation on 64 pairs;
     the GRAMMAR prefilter over 1 + 100 columns, top-10001, against numpy
     float64 on 4096 SNPs and the float64 ranking's sets (boundary swaps
     counted);
     `run_gwas` on phase 3's table with kinship_snps and the SNP arm
     two_steps (100 permutations; K1, K2 and not K7), the planted SNP
     past the 5 % threshold, p-values of 4 x 32 SNPs against the scipy
     oracle, stage seconds, the SNP arm's peak host RSS increase (under
     1.5 GB) and device memory; one_step on the first 2^14 SNPs x 101
     columns; the CLI `kinship-bed`, `associate-snps` and `gwas` with the
     SNP flags, --device cuda against --device cpu;
 20. the EMMA library on the card (phase_emma): emma_ML_LRT and
     emma_REML_t at n=1008 (phase 8's kinship), 4096 variants, g=2, NaNs
     in ~1 % of the xs entries and in one ys row, against the port's CPU
     float64 run on 128 of the variants; calc_gamma on phase 3's table,
     card against CPU;
 21. reads to results through the port's CLI (phase_ingest): the
     reference's E. coli example at its published shape (241 accessions,
     k=31, MAC 5, -p 0.2) on simulated 500-kb genomes (mutations along a
     random tree, a 300-bp cassette in half, phenotype 3 x carrier +
     N(0, 0.5), 5x coverage of 100-bp reads, half reverse-complemented):
     `count` x2 and `strand-merge` per accession in a thread pool (the
     native ingest library), `list-kmers`, `build-table`; on 8 accessions
     the numpy route (--no-native) byte-identical to the native one;
     `gwas --device cuda` (K7, K1, K2; 100 permutations, top-10001,
     host64, --certify_topk) with the cassette's k-mers past
     threshold_5per, its kinship equal to a float64 Gram of the table,
     every column certified and 4 columns' top-k equal to the f64
     oracle's; `gwas-mp` in 2 processes sharing the card (K7, K3)
     writing gwas's artifacts byte for byte, every column certified, its
     kinship the float64 Gram's; `filter-kmers` and
     `table-to-bed -u` on the passing k-mers equal to the table's rows; a
     `kmc-export` -> `kmc-import` round trip and `histogram`; each step's
     wall, the table's rows and bytes, the host's cores;
 22. the single-process device mesh with its shards on the one card
     (phase_mesh): `associate(mesh=)` over 2 and 4 shards on phase 3's
     table equal to phase 3's result (rows, order, certified f64
     re-scores; K1 on every shard's batch), `kinship_from_table(mesh=)`
     over 2 shards equal to phase 8's K (K7 per shard), and the CLI
     `associate`, `kinship` and `gwas` with --devices 2 byte-identical
     to --devices 1;
 23. `gwas-mp` in 8 processes sharing the card on phase 21's table,
     SIGKILLed once every process's scan checkpoint exists, then run
     again: phase 21's `gwas` artifacts byte for byte (phase_crash_resume);
     the walls of the killed and the resumed runs;
 24. the five tools without a TPU kernel (prof_step, prof_r5_certify,
     prof_r5_feedgap, bench_ingest, at_scale_run), each once in a new
     process at a reduced size: exit 0 and JSON that parses
     (phase_tools); the smoke's wall time.
The script writes its inputs itself and imports nothing of the JAX
package. The bench's and the at-scale stream's JSON lines come on earlier
lines. The line before the last is the kernels' JSON record (per kernel:
launches on its path, max abs error against its plain version, kernel and
plain times, the bound at the card's peaks and what sets it, and the
library call's time, null where no single PyTorch call computes the same
function); the last line is {"ok": true, "device": {...}}. Without CUDA
the script fails at once.
"""
import json
import math
import os
import re
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
BMAX_SOURCE = "kmersgwas_tpu_torch/csrc/score_plane.cu"
TILEMAX_SOURCE = "kmersgwas_tpu_torch/csrc/score_tilemax.cu"
SCORE_T_SOURCE = BMAX_SOURCE
SCORE_ROWS_SOURCE = BMAX_SOURCE
KINSHIP_SOURCE = "kmersgwas_tpu_torch/csrc/kinship_gram.cu"
TOPW_REPLACES = "kmersgwas_tpu/ops/score.py:448"
BMAX_REPLACES = "kmersgwas_tpu/ops/score.py:178"
TILEMAX_REPLACES = "kmersgwas_tpu/ops/score.py:269"
SCORE_T_REPLACES = "kmersgwas_tpu/ops/score.py:109"
SCORE_ROWS_REPLACES = "kmersgwas_tpu/ops/score.py:630"
KINSHIP_REPLACES = "tools/prof_kinship.py:18"
GEN_SOURCE = "kmersgwas_tpu_torch/csrc/gen_planes.cu"
GEN_REPLACES = "bench.py:320"
PARITY_SOURCE = "kmersgwas_tpu_torch/csrc/score_parity.cu"
PARITY_REPLACES = "tools/prof_r5_epi.py:419"
REDUCE_SOURCE = "kmersgwas_tpu_torch/csrc/tile_reduce.cu"
REDUCE_REPLACES = "tools/exp_kernel.py:33"
TOPC_REPLACES = "tools/exp_kernel.py:689"
# rows of the bench's synthetic table in phase 14 (the root bench's 8M
# cut to the main path's 4.2M)
BENCH_FEED_ROWS = 4_200_000
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
    kernel = ""
    for ln in lib.log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
        if any(k in kernel for k in REGISTER_KERNELS):
            continue                    # summed up per instance below
        if "registers" in ln or "spill" in ln or "Compiling entry" in ln \
                or "wgmma" in ln:
            log("  ptxas: " + ln.strip())
    table = ptxas_table(lib.log)
    for line in ptxas_summary(table):
        log("  ptxas: " + line)
    bad = tensor_core_spills(lib.log)
    need(not bad, "the tensor-core kernels spill or serialize their "
         "products:\n" + "\n".join(bad))
    log(f"tensor-core kernels ({', '.join(TENSOR_CORE_KERNELS)}): no "
        "spills, no serialized products")
    bad = local_memory(table)
    need(not bad, "the register kernels use local memory:\n"
         + "\n".join(bad))
    log(f"register kernels ({', '.join(REGISTER_KERNELS)}): no spills and "
        "no stack frame in any instance")
    return dict(card=card, gen_sass=gen_sass(lib))


# K6's and K9's kernels hold their work in registers; each has template
# instances (gen_planes: w32 = 32 or any, popcounts or not; tile_reduce:
# <float4s a lane, fold, ties, count>), summed up one line per kernel (K6)
# or per float4 count (K9)
REGISTER_KERNELS = ("gen_planes", "tile_reduce_kernel")


def ptxas_table(ptxas_log):
    """{mangled kernel name: {"registers", "spill_stores", "spill_loads",
    "stack"}} from ptxas -v output."""
    out, kernel = {}, None
    for ln in ptxas_log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$]+)'?", ln)
        if m:
            kernel = m.group(1)
            out.setdefault(kernel, {})
            continue
        if kernel is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            out[kernel].update(stack=int(m.group(1)),
                               spill_stores=int(m.group(2)),
                               spill_loads=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", ln)
        if m:
            out[kernel]["registers"] = int(m.group(1))
    return out


def local_memory(table):
    """The instances of the register kernels (REGISTER_KERNELS) whose ptxas
    lines report spills or a stack frame: local memory, where an array of
    registers indexed at run time or a spill lands."""
    return [f"{name}: {info}" for name, info in sorted(table.items())
            if any(k in name for k in REGISTER_KERNELS)
            and (info.get("stack", 0) or info.get("spill_stores", 0)
                 or info.get("spill_loads", 0))]


def template_args(mangled):
    """The integer and bool template arguments of a mangled kernel name,
    e.g. _ZN3kgt18tile_reduce_kernelILi16ELb1ELi2ELb0EEEv... -> (16, 1, 2,
    0); () for a kernel that is not a template."""
    m = re.search(r"I((?:L[ib]\d+E)+)E", mangled)
    return tuple(int(v) for v in re.findall(r"L[ib](\d+)E", m.group(1))) \
        if m else ()


def ptxas_summary(table):
    """One line per K6 kernel instance and one per K9 float4 count:
    registers and spills of each instance."""
    lines = []
    for name, info in sorted(table.items()):
        if "gen_planes" in name:
            kind = "w32_kernel" if "w32_kernel" in name else "any_kernel"
            lines.append(
                f"gen_planes_{kind}<popcount={template_args(name)[0]}>: "
                f"{info.get('registers')} registers, "
                f"{info.get('spill_stores')} B spill stores, "
                f"{info.get('spill_loads')} B spill loads, "
                f"{info.get('stack')} B stack")
    by_nv = {}
    for name, info in table.items():
        if "tile_reduce_kernel" in name:
            nv, fold, ties, cnt = template_args(name)
            by_nv.setdefault(nv, []).append(
                (fold, ties, cnt, info.get("registers"),
                 info.get("spill_stores", 0) + info.get("spill_loads", 0)
                 + info.get("stack", 0)))
    for nv in sorted(by_nv):
        lines.append(
            f"tile_reduce_kernel<NV={nv}, FOLD, TIES, CNT> registers (spill "
            "and stack B): " + ", ".join(f"<{f},{t},{c}> {r} ({sp})"
                                         for f, t, c, r, sp
                                         in sorted(by_nv[nv])))
    return lines


# K6's integer work: instructions per Philox block in the compiled w32 =
# 32 kernel with popcounts (one trip of its chunk loop makes 8 blocks), and
# the issue rates that bound them on each SM a clock (Hopper, compute
# capability 9.0: 64 IMADs, 64 LOP3s, 16 POPCs, 4 warp instructions)
GEN_BLOCKS_PER_TRIP = 8
SM_RATES = {"imad": 64, "lop3": 64, "popc": 16, "all": 128}


def sass_opcodes(sass, kernel_part):
    """{opcode class: count} of the first function of cuobjdump -sass
    output whose name contains kernel_part: "imad" (IMAD*), "lop3",
    "popc", and "all" (every instruction but NOP)."""
    counts, inside = {"imad": 0, "lop3": 0, "popc": 0, "all": 0}, False
    for ln in sass.splitlines():
        if "Function :" in ln:
            if inside:
                break
            inside = kernel_part in ln
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P[T0-9]\s+)?"
                      r"([A-Z][A-Z0-9_]*)", ln) if inside else None
        if not m or m.group(1) == "NOP":
            continue
        op = m.group(1)
        counts["all"] += 1
        if op.startswith("IMAD"):
            counts["imad"] += 1
        elif op == "LOP3":
            counts["lop3"] += 1
        elif op == "POPC":
            counts["popc"] += 1
    return counts


def int_floor_ms(per_block, n_blocks, sms, clock_hz):
    """(floor in ms, the class that sets it): the Philox blocks' integer
    instructions over each class's issue rate on `sms` SMs at clock_hz."""
    t = {k: per_block[k] * n_blocks / (SM_RATES[k] * sms * clock_hz) * 1e3
         for k in SM_RATES}
    worst = max(t, key=t.get)
    return t[worst], worst


def gen_sass(lib):
    """K6's integer floor at (2^21, 32) from the SASS of the built kernel:
    -> {"per_block": {class: instructions}, "floor_ms", "floor_by",
    "sms", "clock_mhz"}."""
    import torch
    from kmersgwas_tpu_torch.ops import _cuda
    tool = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib.path], capture_output=True,
                          text=True, timeout=300)
    need(sass.returncode == 0, f"cuobjdump failed: {sass.stderr[-2000:]}")
    counts = sass_opcodes(sass.stdout, "gen_planes_w32_kernelILb1E")
    need(counts["all"] > 0, "cuobjdump: no gen_planes_w32_kernel<true>")
    per_block = {k: v / GEN_BLOCKS_PER_TRIP for k, v in counts.items()}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    need(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    clock_mhz = float(smi.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    floor, by = int_floor_ms(per_block, (1 << 21) * 8, sms, clock_mhz * 1e6)
    log(f"K6 SASS (cuobjdump, gen_planes_w32_kernel<true>, one chunk trip "
        f"/ {GEN_BLOCKS_PER_TRIP} blocks): per Philox block "
        + ", ".join(f"{k} {v:.2f}" for k, v in per_block.items())
        + f"; integer floor at (2^21, 32) {floor:.4f} ms, set by {by} "
        f"({sms} SMs at {clock_mhz:.0f} MHz)")
    return dict(per_block=per_block, floor_ms=floor, floor_by=by, sms=sms,
                clock_mhz=clock_mhz)


# the kernels on wgmma: csrc/score_wgmma.cuh's body (K1's tile launch,
# also K8's; K3; K4 / K2 / K5, score_plane_kernel<N8, 0 / 1 / 2>) and K7's
# int8 Gram (csrc/kinship_gram.cu)
TENSOR_CORE_KERNELS = ("score_topw_tiles", "score_tilemax", "score_plane",
                       "kinship_gram")
# score_plane_kernel's MODE for each of its entry points
# (csrc/score_plane.cu PLANE_T, PLANE_BMAX, PLANE_ROWS)
PLANE_MODES = {"score_t": 0, "score_bmax": 1, "score_rows": 2}


def is_plane_kernel(name, entry):
    """Whether a profiled kernel's name is score_plane_kernel's instance
    for `entry`, demangled as score_plane_kernel<N8, MODE>."""
    return re.search(rf"score_plane_kernel<\d+, {PLANE_MODES[entry]}>",
                     name) is not None


def tensor_core_spills(ptxas_log):
    """The ptxas lines (-v) that report spills of the tensor-core kernels
    (TENSOR_CORE_KERNELS) or products that ptxas serialized."""
    bad, kernel = [], ""
    for ln in ptxas_log.splitlines():
        if "Compiling entry function" in ln:
            kernel = ln.split("'")[1]
        elif "wgmma" in ln and "serialized" in ln:
            bad.append(ln.strip())
        elif any(k in kernel for k in TENSOR_CORE_KERNELS):
            m = re.search(r"(\d+) bytes spill stores", ln)
            if m and int(m.group(1)):
                bad.append(f"{kernel}: {ln.strip()}")
    return bad


# ---------------------------------------------------------------- phase 2

def make_planes(rows, n, seed, pad_rows=0, device="cuda"):
    """Random packed planes on the card (bits past n zero, the last
    `pad_rows` rows zero = padding) and their popcounts."""
    import torch
    from kmersgwas_tpu_torch.ops import bitplanes
    n_pad = -(-n // 128) * 128
    w32 = n_pad // 32
    g = torch.Generator(device=device).manual_seed(seed)
    packed = torch.randint(-2 ** 31, 2 ** 31, (rows, w32), dtype=torch.int32,
                           device=device, generator=g)
    lane_ok = np.zeros(n_pad, np.uint8)
    lane_ok[:n] = 1
    mask = torch.from_numpy(
        bitplanes.pack_bits_np(lane_ok).view(np.int32)).to(device)
    packed &= mask
    if pad_rows:
        packed[rows - pad_rows:] = 0
    return packed, bitplanes.popcount_rows(packed)


def make_batch(rows, n, p, seed, pad_rows, gaussian, device="cuda"):
    """make_planes plus phenotypes (padded y and column sums)."""
    from kmersgwas_tpu_torch.ops import score
    packed, popcnt = make_planes(rows, n, seed, pad_rows, device)
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(n, p)).astype(np.float32) if gaussian
         else dyadic(rng, (n, p)))
    yp, ysum = score.prepare_phenotypes(y, -(-n // 128) * 128, device)
    return packed, popcnt, yp, ysum


def tie_runs(packed):
    """The batch with runs of 4 equal rows over its first half: tiles whose
    2nd and 3rd values tie (n2 = 3, n3 = 2 at their top)."""
    from kmersgwas_tpu_torch.ops import bitplanes
    t = packed.clone()
    v = t.view(-1, 4, t.shape[1])
    v[:v.shape[0] // 2, 1:] = v[:v.shape[0] // 2, :1]
    return t, bitplanes.popcount_rows(t)


def check_tilemax_at(packed, yp, ysum, gaussian, prec, kw, label, timing):
    """K3 against its plain version on the tie-run variant of a batch, at
    thresholds -inf, a high quantile and +inf. Dyadic phenotypes: all nine
    planes bit-equal. Gaussian ones: the values are within the RTOL bound
    of the plain version's, lanes and n2/n3 equal it wherever the values
    agree, cnt wherever no lane's plain score lies within the RTOL bound
    of thresh; where K1's list can hold every tile's top 3 (3 x tiles <=
    1024), the three (value, lane) pairs of every tile equal K1's list
    exactly (K1 and K3 share the tensor-core body).
    -> (max abs err of the values, (kernel ms, plain ms) or None)."""
    import torch
    from kmersgwas_tpu_torch.ops import score
    packed, pc = tie_runs(packed)
    p = yp.shape[1]
    n_tiles = packed.shape[0] // 128
    ps = score.scores_t_plain(packed, pc, yp, ysum, precision=prec, **kw)
    scale = col_scale(ps)
    kth = max(1, min(100, packed.shape[0] // 64))
    q = torch.topk(ps, kth, dim=1).values[:, -1].contiguous()
    err, times = 0.0, None
    for th_name, th in (("-inf", torch.full((p,), float("-inf"),
                                            device="cuda")),
                        ("quantile", q),
                        ("+inf", torch.full((p,), float("inf"),
                                            device="cuda"))):
        args = (packed, pc, yp, ysum, th)
        tkw = dict(tile_rows=128, precision=prec, **kw)
        got = score.score_batch_t_tilemax(*args, **tkw)
        torch.cuda.synchronize()
        want = score.tilemax_plain(*args, **tkw)
        tag = f"{label}: K3 ({'gauss' if gaussian else 'dyadic'} {prec}, " \
              f"th {th_name})"
        need(bool((got[6] > 1).any()) and bool((got[7] > 1).any()),
             f"{tag}: no tile with tied 2nd and 3rd values")
        if not gaussian:
            need(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{tag}: planes != plain")
            continue
        if 3 * n_tiles <= 1024:
            kv, kg, _ = score.score_batch_t_topw(
                *args, tile_rows=128, cand_w=3 * n_tiles, precision=prec,
                **kw)
            base = 128 * torch.arange(n_tiles, device="cuda")[None, :, None]
            v3 = torch.stack((got[0], got[2], got[4]), dim=-1)
            g3 = torch.stack((got[1], got[3], got[5]), dim=-1) + base
            sv, sg = score._select(v3.reshape(p, -1),
                                   g3.reshape(p, -1).to(torch.int32),
                                   3 * n_tiles)
            need(torch.equal(sv, kv) and torch.equal(sg, kg),
                 f"{tag}: the tiles' top 3 differ from K1's list")
        eq = []
        for i in (0, 2, 4):
            fin = torch.isfinite(want[i])
            need(torch.equal(torch.isfinite(got[i]), fin),
                 f"{tag}: -inf entries differ")
            d = torch.where(fin, (got[i] - want[i]).abs(), 0.0)
            err = max(err, float(d.max()))
            need(bool((d <= RTOL * (torch.where(fin, want[i].abs(), 0.0)
                                    + scale)).all()),
                 f"{tag}: values off by {float(d.max())}")
            eq.append((got[i] == want[i]) | ~fin)
        m1, m2, m3 = eq[0], eq[0] & eq[1], eq[0] & eq[1] & eq[2]
        t = th[:, None]
        band = RTOL * (torch.where(torch.isfinite(t), t.abs(), 0.0) + scale)
        agree = ~((ps - t).abs() <= band).view(p, -1, 128).any(dim=-1)
        for i, m in ((1, m1), (3, m2), (6, m2), (5, m3), (7, m3),
                     (8, agree)):
            need(torch.equal(got[i][m], want[i][m]),
                 f"{tag}: plane {i} differs where the values agree")
    if timing:
        args = (packed, pc, yp, ysum, q)
        tkw = dict(tile_rows=128, precision=prec, **kw)
        times = (cuda_ms(lambda: score.score_batch_t_tilemax(*args, **tkw)),
                 cuda_ms(lambda: score.tilemax_plain(*args, **tkw)))
    log(f"  {label} {'gauss' if gaussian else 'dyadic'} {prec:8s} K3: nine "
        f"planes checked at 3 thresholds")
    return err, times


def check_scores_at(packed, pc, yp, ysum, gaussian, prec, kw, label, timing):
    """K4 (score_t, (P, R) with -inf padding rows) and K5 (score_rows,
    (R, P), no padding mask) against their plain versions: bit-equal on
    dyadic phenotypes, within the RTOL bound on Gaussian ones. -> (max abs
    err K4, K5, (K4 ms, plain ms, K5 ms, plain ms) or None)."""
    import torch
    from kmersgwas_tpu_torch.ops import score
    args = (packed, pc, yp, ysum)
    tkw = dict(precision=prec, **kw)
    errs = []
    for name, kern, plain, scale_dim in (
            ("K4", score.score_batch_t, score.scores_t_plain, 1),
            ("K5", score.score_batch, score.scores_plain, 0)):
        got = kern(*args, **tkw)
        torch.cuda.synchronize()
        want = plain(*args, **tkw)
        tag = f"{label}: {name} ({'gauss' if gaussian else 'dyadic'} {prec})"
        need(got.shape == want.shape, f"{tag}: shape {tuple(got.shape)}")
        fin = torch.isfinite(want)
        need(torch.equal(torch.isfinite(got), fin), f"{tag}: -inf entries")
        need((name == "K5") == bool(fin.all()),
             f"{tag}: padding rows {'masked' if name == 'K5' else 'unmasked'}")
        if gaussian:
            d = torch.where(fin, (got - want).abs(), 0.0)
            scale = torch.where(fin, want.abs(), 0.0).amax(
                dim=scale_dim, keepdim=True)
            errs.append(float(d.max()))
            need(bool((d <= RTOL * (torch.where(fin, want.abs(), 0.0)
                                    + scale)).all()),
                 f"{tag}: scores off by {float(d.max())}")
        else:
            errs.append(0.0)
            need(torch.equal(got, want), f"{tag}: != plain, max diff "
                 f"{float(torch.where(fin, (got - want).abs(), 0).max())}")
        del got, want
    times = None
    if timing:
        times = (cuda_ms(lambda: score.score_batch_t(*args, **tkw)),
                 cuda_ms(lambda: score.scores_t_plain(*args, **tkw), reps=3),
                 cuda_ms(lambda: score.score_batch(*args, **tkw)),
                 cuda_ms(lambda: score.scores_plain(*args, **tkw), reps=3))
    log(f"  {label} {'gauss' if gaussian else 'dyadic'} {prec:8s} K4, K5: "
        f"checked against plain")
    return errs[0], errs[1], times


def check_kernels_at(rows, n, p, w, seed, label, timing=False):
    """K1-K5 against their plain versions at one shape. Returns (max abs
    err of K1, K2, K3, K4, K5, times or None)."""
    import torch
    from kmersgwas_tpu_torch.ops import score
    mc = 5
    kw = dict(n_used=n, min_count=mc)
    err1 = err2 = err3 = err4 = err5 = 0.0
    times = t3 = t45 = None
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
            need(k2_equals_k1(ks, kv, kg), f"{label}: K2's scores differ "
                 f"from K1's values at K1's lanes ({prec}, th {th_name})")
            # ok (with the caller's W-th <= thresh check) is conservative:
            # every lane scoring > thresh is in the list, with its score
            # (Gaussian: every lane whose plain score is above thresh by
            # more than the RTOL bound; K1's own scores are not at hand)
            ok_eff = kok & (kv[:, -1] <= th)
            band = (RTOL * (torch.where(torch.isfinite(th), th.abs(), 0.0)
                            + col_scale(ps)[:, 0]) if gaussian
                    else torch.zeros_like(th))
            for c in torch.nonzero(ok_eff).flatten().tolist():
                hot = torch.nonzero((ps[c] if gaussian else ks[c])
                                    > th[c] + band[c]).flatten()
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
        e4, e5, t = check_scores_at(packed, pc, yp, ysum, gaussian, prec, kw,
                                    label, timing and not gaussian
                                    and prec == "default")
        err4, err5 = max(err4, e4), max(err5, e5)
        t45 = t or t45
        torch.cuda.empty_cache()
        e3, t = check_tilemax_at(packed, yp, ysum, gaussian, prec, kw, label,
                                 timing and not gaussian
                                 and prec == "default")
        err3 = max(err3, e3)
        t3 = t or t3
        torch.cuda.empty_cache()
    return err1, err2, err3, err4, err5, (times + t3 + t45 if times
                                          else None)


def k2_equals_k1(ks, kv, kg):
    """K2's (P, R) scores at the lanes of K1's list equal its finite values
    bit for bit (one tensor-core body, the same column chunks)."""
    import torch
    fin = torch.isfinite(kv)
    return torch.equal(ks.gather(1, kg.long())[fin], kv[fin])


def check_flagship_equalities(rows=2_097_152, n=1008, p=101, w=256):
    """On the flagship batch, at both precisions, Gaussian and dyadic: K2's
    score at every lane of K1's list (thresh at the 100th score) is K1's
    value, so the fallback merges K1's buffered candidates with K2's
    rescored batch in one arithmetic; and K5's (R, P) scores are K4's (P,
    R) scores transposed, with -inf (padding rows) as 0, bit for bit (one
    body, the same column chunks, the unmasked score of the same sums)."""
    import torch
    from kmersgwas_tpu_torch.ops import score
    for gaussian in (False, True):
        packed, pc, yp, ysum = make_batch(rows, n, p, 17, rows // 8 + 37,
                                          gaussian)
        for prec in ("default", "highest"):
            kw = dict(n_used=n, min_count=5, precision=prec)
            ks, _ = score.score_batch_t_bmax(packed, pc, yp, ysum, **kw)
            q = torch.topk(ks, 100, dim=1).values[:, -1].contiguous()
            kv, kg, _ = score.score_batch_t_topw(packed, pc, yp, ysum, q,
                                                 tile_rows=128, cand_w=w,
                                                 **kw)
            tag = f"{'gauss' if gaussian else 'dyadic'} {prec}"
            need(k2_equals_k1(ks, kv, kg), f"flagship {tag}: K2's scores "
                 "differ from K1's values at K1's lanes")
            del ks
            k4 = score.score_batch_t(packed, pc, yp, ysum, **kw)
            k4 = torch.where(k4 == float("-inf"), 0.0, k4).T.contiguous()
            k5 = score.score_batch(packed, pc, yp, ysum, **kw)
            need(torch.equal(k5, k4), f"flagship {tag}: K5 != K4 transposed "
                 f"(-inf as 0) at {int((k5 != k4).sum())} entries")
            log(f"  flagship {tag}: K2's scores equal K1's "
                f"{int(torch.isfinite(kv).sum())} values at K1's lanes; "
                f"K5's ({rows}, {p}) scores equal K4's transposed, -inf as "
                "0, bit for bit")
            del k4, k5
        del packed, pc
        torch.cuda.empty_cache()


def check_kinship_at(rows, n, n_rows, seed, label, timing=False):
    """K7 (kinship_accumulate: the bit transpose, then the kinship_gram
    kernel) against kinship_gram_plain: the +-1 Gram of rows [0, n_rows) of
    a (rows, W32) buffer whose tail is random (it must add nothing), added
    in place onto a non-zero accumulator; integer, so bit-equal. The
    transpose alone against transpose_bits_plain. -> for a full buffer,
    (call ms, plain ms, transpose call ms, transpose plain ms, transpose
    kernel ms, Gram kernel ms, _int_mm yardstick ms), else None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kmersgwas_tpu_torch.ops import bitplanes, kinship
    packed, _ = make_planes(rows, n, seed)
    n_pad = packed.shape[1] * 32
    acc0 = torch.randint(-9, 9, (n_pad, n_pad), dtype=torch.int32,
                         device="cuda")
    acc = acc0.clone()
    kinship.kinship_accumulate(acc, packed, n_rows)
    torch.cuda.synchronize()
    want = kinship.kinship_gram_plain(packed, n_rows)
    need(torch.equal(acc - acc0, want),
         f"{label}: K7 != plain, {int((acc - acc0 != want).sum())} entries")
    need(torch.equal(want, want.T), f"{label}: plain Gram not symmetric")
    del want
    bits = kinship.transpose_bits(packed, n_rows)
    need(torch.equal(bits, kinship.transpose_bits_plain(packed, n_rows)),
         f"{label}: K7's bit transpose != plain")
    del bits
    log(f"  {label}: K7 bit-equal to plain, its transpose too (n_rows "
        f"{n_rows} of {rows} rows, n_pad {n_pad})")
    if not timing:
        return None
    acc.zero_()
    t = (cuda_ms(lambda: kinship.kinship_accumulate(acc, packed, rows)),
         cuda_ms(lambda: kinship.kinship_gram_plain(packed, rows), reps=3),
         cuda_ms(lambda: kinship.transpose_bits(packed, rows)),
         cuda_ms(lambda: kinship.transpose_bits_plain(packed, rows), reps=3))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            kinship.kinship_accumulate(acc, packed, rows)
        torch.cuda.synchronize()
    _, per = device_busy(prof)
    tk = [sum(ms for k, ms in per.items() if name in k) / 5
          for name in ("kinship_transpose_kernel", "kinship_gram_kernel")]
    # product-only yardstick: the full Gram of the +-1 operand unpacked
    # beforehand (not K7's function: no unpack, no triangle, no row mask)
    a = bitplanes.unpack_bits_pm1(packed)
    t_mm = cuda_ms(lambda: torch._int_mm(a.T, a))
    del a
    torch.cuda.empty_cache()
    return t + tuple(tk) + (t_mm,)


def select_bound_ms(rows, p, w, tile_rows=128, lists=1):
    """The least time of K1's select launch: what it has to read once, at
    the card's HBM rate (bench.CARD_PEAKS): each tile's three scores and
    count (16 B a tile and column) and the lanes of the w winners of each
    list (4 B each). K8's two lists read its probe tiles (tile_rows) the
    same way."""
    from kmersgwas_tpu_torch import bench
    tiles = rows // tile_rows
    read = p * tiles * (3 * 4 + 4) + lists * p * w * 4
    return read / bench.CARD_PEAKS[0][1].hbm_bytes * 1e3


def log_select_paths(fn, label):
    """One call of fn under utils.tracing(): the `topw_select.<path>`
    counts of its select launches and the blocks that took the radix
    fallback (score.select_fallbacks, the kernel's device tally)."""
    import torch
    from kmersgwas_tpu_torch import utils
    from kmersgwas_tpu_torch.ops import score
    fb = score.select_fallbacks("cuda")
    with utils.tracing():
        fn()
    torch.cuda.synchronize()
    paths = {k: v for k, v in utils.last_trace().counters.items()
             if k.startswith("topw_select.")}
    log(f"{label}: select launches by path {paths}, radix fallbacks "
        f"{score.select_fallbacks('cuda') - fb} blocks")


def time_step_kernels(rows=2_097_152, n=1008, p=101, w=256):
    """K1 (its tile and select launches apart), K3, and K2, K4 and K5 (their
    kernels apart from the wrappers' operand build) on one flagship batch
    at both precisions; the same at N=100 ("default"), whose k loop is 2
    ring stages against 16, so the difference is the k loop's share of the
    tile launch; and a GEMM-only yardstick: the bf16 torch.matmul of the
    flagship's bits, unpacked beforehand, by (N_pad, P rounded up to 8).
    The yardstick computes no score and no selection, so it is no
    library_ms: it shows what the product alone costs."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kmersgwas_tpu_torch.ops import bitplanes, score
    # the flagship last: the yardstick multiplies its bits
    for n_s, precs in ((100, ("default",)), (n, ("default", "highest"))):
        packed, pc, yp, ysum = make_batch(rows, n_s, p, 7, 0, False)
        kw = dict(n_used=n_s, min_count=5)
        ps = score.scores_t_plain(packed, pc, yp, ysum, **kw)
        q = torch.topk(ps, 100, dim=1).values[:, -1].contiguous()
        del ps
        args = (packed, pc, yp, ysum, q)
        for prec in precs:
            def k1():
                return score.score_batch_t_topw(*args, tile_rows=128,
                                                cand_w=w, precision=prec,
                                                **kw)

            def k2():
                return score.score_batch_t_bmax(*args[:4], precision=prec,
                                                **kw)

            def k4():
                return score.score_batch_t(*args[:4], precision=prec, **kw)

            def k5():
                return score.score_batch(*args[:4], precision=prec, **kw)
            t_k1 = cuda_ms(k1)
            t_k3 = cuda_ms(lambda: score.score_batch_t_tilemax(
                *args, tile_rows=128, precision=prec, **kw))
            t_k2, t_k4, t_k5 = cuda_ms(k2), cuda_ms(k4), cuda_ms(k5)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for fn in (k1, k2, k4, k5):
                    for _ in range(5):
                        fn()
                torch.cuda.synchronize()
            _, per = device_busy(prof)

            def kernel_ms(key):
                return sum(t for k, t in per.items() if key(k)) / 5
            tile = kernel_ms(lambda k: "score_topw_tiles" in k)
            sel = kernel_ms(lambda k: "topw_select" in k)
            p2, p4, p5 = (kernel_ms(lambda k, e=e: is_plane_kernel(k, e))
                          for e in ("score_bmax", "score_t", "score_rows"))
            log(f"{'flagship' if n_s == n else f'N={n_s}'} {prec}: K1 "
                f"score_topw {t_k1:.3f} ms (tile launch {tile:.3f} ms, "
                f"select launch {sel:.4f} ms by the profiler against its "
                f"bound {select_bound_ms(rows, p, w):.4f} ms), K3 "
                f"score_tilemax {t_k3:.3f} ms, K2 score_bmax {t_k2:.3f} ms "
                f"(kernel {p2:.3f} ms by the profiler), K4 score_t "
                f"{t_k4:.3f} ms (kernel {p4:.3f} ms), K5 score_rows "
                f"{t_k5:.3f} ms (kernel {p5:.3f} ms) (whole calls: median "
                f"CUDA-event times)")
    log_select_paths(lambda: score.score_batch_t_topw(
        *args, tile_rows=128, cand_w=w, **kw), f"K1 at R={rows}, W={w}")
    g = bitplanes.unpack_bits(packed, torch.bfloat16)
    yb = torch.zeros((g.shape[1], -(-p // 8) * 8), dtype=torch.bfloat16,
                     device="cuda")
    yb[:, :p] = yp.to(torch.bfloat16)
    t_mm = cuda_ms(lambda: torch.matmul(g, yb))
    log(f"GEMM-only yardstick: bf16 torch.matmul {tuple(g.shape)} x "
        f"{tuple(yb.shape)} of the bits unpacked beforehand: {t_mm:.3f} ms "
        f"(no score, no selection; not the kernels' function)")
    del g, yb
    torch.cuda.empty_cache()


def phase_kernels():
    """-> the largest errors measured over every shape (Gaussian phenotypes
    at "highest"; dyadic ones are checked bit-equal), the flagship times
    and K4's launches (no scan path runs K4: its checks here are its
    use)."""
    from kmersgwas_tpu_torch.ops import score
    score.score_batch_t.launches = 0
    e = [0.0] * 5
    for rows, n, p, w in ((1024, 100, 3, 16), (1024, 100, 70, 256),
                          (1024, 300, 1013, 64), (4096, 1008, 101, 256)):
        *errs, _ = check_kernels_at(rows, n, p, w, seed=rows + p,
                                    label=f"R={rows} N={n} P={p} W={w}")
        e = [max(a, b) for a, b in zip(e, errs)]
    *errs, times = check_kernels_at(2_097_152, 1008, 101, 256, seed=7,
                                    label="flagship", timing=True)
    e = [max(a, b) for a, b in zip(e, errs)]
    log(f"flagship K1 score_topw: kernel {times[0]:.3f} ms, plain "
        f"{times[1]:.3f} ms; K2 score_bmax: kernel {times[2]:.3f} ms, plain "
        f"{times[3]:.3f} ms; K3 score_tilemax: kernel {times[4]:.3f} ms, "
        f"plain {times[5]:.3f} ms; K4 score_t: kernel {times[6]:.3f} ms, "
        f"plain {times[7]:.3f} ms; K5 score_rows: kernel {times[8]:.3f} ms, "
        f"plain {times[9]:.3f} ms (median CUDA-event times)")
    log(f"max abs err over all shapes (gaussian, highest): K1 {e[0]:.3g}, "
        f"K2 {e[1]:.3g}, K3 {e[2]:.3g}, K4 {e[3]:.3g}, K5 {e[4]:.3g}")
    check_flagship_equalities()
    time_step_kernels()
    for rows, n, n_rows in ((4096, 100, 4001), (640, 300, 1),
                            (20_000, 1008, 19_963)):
        check_kinship_at(rows, n, n_rows, seed=rows + n,
                         label=f"R={rows} N={n}")
    check_kinship_at(1 << 20, 1008, (1 << 20) - 37, seed=9,
                     label="flagship ragged")
    kt = check_kinship_at(1 << 20, 1008, 1 << 20, seed=8,
                          label="flagship", timing=True)
    ops = 2 * (1 << 20) * 1024 * 1024
    log(f"flagship K7 kinship_accumulate (2^20 rows, n_pad 1024): whole "
        f"call {kt[0]:.3f} ms ({ops / kt[0] / 1e9:.1f} T int8 op/s of the "
        f"full Gram), plain {kt[1]:.3f} ms; by the profiler the transpose "
        f"kernel {kt[4]:.4f} ms and the Gram kernel {kt[5]:.3f} ms; the "
        f"transpose's call {kt[2]:.4f} ms, plain {kt[3]:.3f} ms (whole "
        f"calls: median CUDA-event times)")
    log(f"product-only yardstick: torch._int_mm of the (2^20, 1024) +-1 "
        f"int8 operand unpacked beforehand, the full Gram: {kt[6]:.3f} ms "
        f"({ops / kt[6] / 1e9:.1f} T int8 op/s; not K7's function)")
    return dict(errs=e, times=times + kt, k4=score.score_batch_t.launches)


# ---------------------------------------------------------------- phase 3

_BYTE_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None],
                               axis=1).sum(axis=1).astype(np.uint8)


# the .table header: magic, accession count, k-mer length (little endian)
TABLE_HEADER = struct.Struct("<IQI")
TABLE_MAGIC = 0xDDCCBBAA


def write_table(base, n, n_rows, kmer_len, seed, kmer_step=97):
    """Synthetic .table and .names (the layout bench.py:34-64 writes, with
    every file bit past n zero; k-mer codes row * kmer_step) -> (names,
    popcount of every row)."""
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
            rows[:, 0] = np.arange(s, s + m, dtype=np.uint64) * np.uint64(
                kmer_step)
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


def oracle_top(base, n, y_cols, keep, k, chunk=1 << 18, device="cuda"):
    """f64 brute force: per column, the top-k table rows by (exact score
    desc, row asc) among MAC-passing rows, with their scores. The bits are
    unpacked and multiplied by y in float64 with torch on `device` (plain
    torch, none of the port's code), the top-k merged in numpy."""
    import torch
    wf = (n + 63) // 64
    raw = np.memmap(base + ".table", dtype="<u8", mode="r",
                    offset=TABLE_HEADER.size).reshape(-1, 1 + wf)
    y = torch.from_numpy(y_cols.astype(np.float64)).to(device)
    ysum = y.sum(0)
    shifts = torch.arange(8, dtype=torch.uint8, device=device)
    best = [(np.empty(0), np.empty(0, np.int64))] * y.shape[1]
    for s in range(0, raw.shape[0], chunk):
        blk = torch.from_numpy(np.ascontiguousarray(raw[s:s + chunk, 1:])
                               .view(np.uint8)).to(device)
        bits = ((blk[:, :, None] >> shifts) & 1).reshape(
            blk.shape[0], -1)[:, :n].to(torch.float64)
        n1 = bits.sum(1, keepdim=True)
        r = n * (bits @ y) - n1 * ysum
        denom = n * n1 - n1 * n1
        sc = torch.where(denom > 0, r * r / denom,
                         torch.zeros_like(r)).cpu().numpy()
        del blk, bits
        rows = np.arange(s, s + sc.shape[0])
        kk = keep[s:s + sc.shape[0]]
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
    # k-mer codes spread over the whole k-mer space, so that phase 7's
    # processes own equal spans
    names, pcs = write_table(base, n, n_rows, kmer_len, seed=1,
                             kmer_step=(1 << 2 * kmer_len) // n_rows)
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
    best = oracle_top(base, n, y[:, check_cols], keep, k, device=device)
    for j, (bv, br) in zip(check_cols, best):
        need(np.array_equal(res.rows[j], br),
             f"column {j}: rows differ from the f64 oracle "
             f"({np.sum(res.rows[j] != br)} of {k})")
        need(np.allclose(res.scores[j], bv, rtol=1e-12, atol=0),
             f"column {j}: certified scores differ from the f64 oracle")
    log(f"main: all {p} columns certified; columns {list(check_cols)} equal "
        f"the f64 oracle's top-{k} (oracle {time.perf_counter() - t0:.1f} s)")
    return dict(k1=k1, k2=k2, res=res, k=k, batch=batch, base=base,
                dtable=dtable, names=names, y=y,
                cols=cols, n_tested=int(keep.sum()), kmer_len=kmer_len,
                keep=keep, n=n)


# ---------------------------------------------------------------- phase 4

def device_busy(prof):
    """(summed time in ms of every kernel, copy and fill the device ran,
    {name: ms}) of a torch.profiler run. Only the device's own events
    count: the host ops that launched the kernels, and the device spans of
    record_function ranges, carry the same time again."""
    from torch.autograd import DeviceType
    per = {}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA or is_range(e.name) \
                or getattr(e, "is_user_annotation", False):
            continue
        per[e.name] = per.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    return sum(per.values()), per


def in_fresh_process(call):
    """Run `call` (an expression over this module's functions, e.g.
    "probe_kernels_ms()") in a new Python process and relay its output. The
    profiler keeps only the device events whose timestamps fall inside its
    window, and late in this long process the device's timestamps drift out
    of it (on the card a window around one call lost its kernels as the
    phases went by, and one around a whole kinship run held none), while a
    new process's profile holds every event."""
    proc = subprocess.run(
        [sys.executable, "-c", f"import chip_smoke as s; s.{call}"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    for ln in proc.stdout.splitlines():
        log(ln)
    need(proc.returncode == 0, f"{call} failed:\n{proc.stderr[-3000:]}")


# phase 4's profiled window of fallback steps starts at this batch, in
# the threshold's ramp (the first append comes at batch ~45 in `cand_w`
# mode, ~115-135 in `cand_c`)
FALLBACK_WINDOW = 5
# the port names the fallback's pieces with torch.profiler ranges
# RANGE + function (ops/scanstep.py's docstring)
RANGE = "kgt::"


def is_range(name):
    """Whether a profiled event is one of the port's ranges, RANGE + a
    function's name. The demangled names of the port's kernels that are
    not templates start with RANGE too (kgt::topw_select_kernel(float
    const*, ...)), but carry their parameter lists."""
    return re.fullmatch(re.escape(RANGE) + r"\w+", name) is not None


def range_ms(prof, name, skip=lambda kernel: False):
    """Device time in ms of the kernels launched inside the port's range
    RANGE + `name`, summed over the profile: the kernels the
    profiler links to the range's host events and their descendants,
    but those whose name `skip` takes."""
    from torch.autograd import DeviceType

    def kernels_us(e):
        return (sum(k.duration for k in e.kernels if not skip(k.name))
                + sum(kernels_us(c) for c in e.cpu_children))
    return sum(kernels_us(e) for e in prof.events()
               if e.name == RANGE + name
               and e.device_type == DeviceType.CPU) / 1e3


def fallback_split(prof, wall, n_steps, kernel):
    """One line: a profiled window's device time per step, split into K2's
    kernel and the rest of its call (the operand build), top_k_from_bmax,
    the rest of _flush_merge, the candidate kernel (`kernel`) and the
    rest."""
    busy, per = device_busy(prof)
    if busy <= 0:
        return "no device time in the trace: not measured"
    # K2's kernel is launched through ctypes, with no PyTorch op: it is
    # found by name. Whether the profiler links it to the range open at
    # its launch depends on the range (record_function: no; the
    # profiler's fast range, the port's spans: yes), so K2's range is
    # read without it, as the PyTorch kernels of its operand build
    k2 = sum(t for nm, t in per.items()
             if is_plane_kernel(nm, "score_bmax"))
    build = range_ms(prof, "score_batch_t_bmax",
                     skip=lambda nm: is_plane_kernel(nm, "score_bmax"))
    tkb = range_ms(prof, "top_k_from_bmax")
    merge = range_ms(prof, "_flush_merge")
    cand = sum(t for nm, t in per.items() if kernel in nm)
    parts = (("K2 kernel", k2), ("K2's operand build", build),
             ("top_k_from_bmax", tkb), ("_flush_merge's rest", merge - tkb),
             (f"{kernel} kernels", cand),
             ("other", busy - k2 - build - merge - cand))
    return (f"wall {wall / n_steps:.2f} ms a step, device busy "
            f"{busy / n_steps:.2f} ms (idle {100 * (1 - busy / wall):.1f} %)"
            "; per step " + ", ".join(
                f"{nm} {t / n_steps:.3f} ms ({100 * t / busy:.1f} %)"
                for nm, t in parts))


def phase_stream(mode="cand_w", n_batches=80, n_prof=5, rows=2_000_000,
                 n=1008, p=101):
    """The scan step's settled regime at the main path's shape (N=1008,
    P=101, 2,000,000-row batches): device-made batches through
    scan_step_compact, so the candidate kernel runs on every batch, K2 on
    the threshold ramp's fallbacks and the append branch once the
    threshold settles. mode "cand_w": the single-process scan's parameters
    (top-10001 + the certify band, K1); "cand_c": the multi-process
    driver's (top-10001, cand_c 256, cand_c2 64, so 384 candidates per
    column, a 6144-slot buffer, q 64; K3). The `cand_c` guard also needs
    every tile holding two lanes above the threshold to rank among the 64
    hottest, so it settles later: with ~k/b lanes per column above the
    threshold at batch b, after ~170-200 batches. Dyadic phenotypes at
    precision "default" make kernel and plain scores bit-equal, so the final top-k
    must equal, scores and rows, a plain running top-k (plain scores, one
    stable sort per batch, earlier rows first on ties). Two windows of
    n_prof steps run back to back under torch.profiler: fallbacks from
    batch FALLBACK_WINDOW on, and the last n_prof steps. Each step outside
    them, and each window, is settled (ss.settle) before it is timed, so
    a time and a branch are its own batches'."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kmersgwas_tpu_torch.ops import scanstep as ss
    from kmersgwas_tpu_torch.ops import score, topk
    from kmersgwas_tpu_torch.pipeline import scan
    min_count = scan.effective_min_count(n, 0.05, 5)
    y = dyadic(np.random.default_rng(11), (n, p))
    yp, ysum = score.prepare_phenotypes(y, -(-n // 128) * 128, "cuda")
    counts = {}
    if mode == "cand_w":
        k, cap, kernel = 10001 + scan.CERTIFY_BAND, scan.BUF_CAP, "topw"
        kw = dict(cand_k=min(max(256, k // 8), k), cand_w=scan.CAND_W,
                  cand_q=scan.CAND_Q)
    else:           # parallel/multihost.run_distributed_scan's formulas
        k, cap, kernel = 10001, (256 + 2 * 64) * 16, "tilemax"
        kw = dict(cand_k=min(max(256, k // 8), k, rows), cand_c=256,
                  cand_c2=64, cand_q=64)
    state = ss.init_buffered_state(p, k, cap, "cuda")
    kw.update(n_used=n, min_count=min_count, tile_rows=scan.TILE_ROWS,
              precision="default", counts=counts)
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

    def profiled(bs):
        """The steps of batches `bs`, back to back under torch.profiler
        (K2's call, top_k_from_bmax and _flush_merge run in the port's
        named ranges), then the oracle. -> (profile, branch counts, wall ms)."""
        batches = [batch(b) for b in bs]
        before = dict(counts)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as pr:
            t_prof = time.perf_counter()
            for args in batches:
                ss.scan_step_compact(state, *args, yp, ysum, **kw)
            ss.settle(state)
            torch.cuda.synchronize()
            wall = 1e3 * (time.perf_counter() - t_prof)
        for b, args in zip(bs, batches):
            oracle(b, *args[:2])
        return pr, {a: counts.get(a, 0) - before.get(a, 0)
                    for a in ("narrow", "wide", "fallback", "flush")}, wall

    tag = f"stream {mode}"
    step_ms = {"append": [], "fallback": []}
    first_append = None
    t0 = time.perf_counter()
    b = 0
    while b < n_batches:
        if b == FALLBACK_WINDOW:            # deep in the threshold's ramp
            fb = profiled(range(b, b + n_prof))
            b += n_prof
            continue
        args = batch(b)
        before = counts.get("fallback", 0)
        torch.cuda.synchronize()
        t_step = time.perf_counter()
        ss.scan_step_compact(state, *args, yp, ysum, **kw)
        ss.settle(state)            # this batch's own branch and time
        torch.cuda.synchronize()
        kind = "fallback" if counts.get("fallback", 0) > before else "append"
        step_ms[kind].append(1e3 * (time.perf_counter() - t_step))
        if kind == "append" and first_append is None:
            first_append = b
        oracle(b, *args[:2])
        b += 1
    prof, prof_kinds, wall_prof = profiled(range(n_batches,
                                                 n_batches + n_prof))
    final = ss.flush_buffered(state)
    got_rows = topk.decode_rows(final.row_lo.cpu().numpy(),
                                final.row_hi.cpu().numpy())
    log(f"{tag}: {n_batches + n_prof} batches of {rows} rows, N={n} P={p} "
        f"k={k} in {time.perf_counter() - t0:.1f} s; branches {counts}; "
        f"first append at batch {first_append}")
    for kind, ms in step_ms.items():
        if ms:
            log(f"{tag}: {kind} step ms median {statistics.median(ms):.2f} "
                f"over {len(ms)} steps (first {ms[0]:.2f}, last {ms[-1]:.2f};"
                f" each step synchronized at its end)")
    busy, per = device_busy(prof)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:3]
    mine = sum(t for nm, t in per.items() if kernel in nm)
    log(f"{tag}: profiled {n_prof} steps {prof_kinds}: wall "
        f"{wall_prof:.2f} ms, device busy {busy:.2f} ms ("
        + (f"idle {100 * (1 - busy / wall_prof):.1f} %); {kernel} kernels "
           f"{mine:.3f} ms = {100 * mine / busy:.1f} % of device time; top "
           "kernels " + ", ".join(f"{nm[:48]} {t:.3f} ms" for nm, t in top)
           if busy > 0 else "no device time in the trace: not measured)"))
    fb_prof, fb_kinds, fb_wall = fb
    log(f"{tag}: profiled {n_prof} steps from batch {FALLBACK_WINDOW} "
        f"{fb_kinds}: " + fallback_split(fb_prof, fb_wall, n_prof, kernel))
    need(fb_kinds["fallback"] == n_prof,
         f"{tag}: the ramp's window took other branches: {fb_kinds}")
    need(counts.get("narrow", 0) + counts.get("wide", 0) >= 10,
         f"{tag}: the append branch ran only {counts} times")
    need(counts.get("fallback", 0) >= 1, f"{tag}: no fallback step: {counts}")
    need(torch.equal(final.scores, ov),
         f"{tag}: final scores differ from the plain running top-k")
    need(np.array_equal(got_rows, orow.cpu().numpy()),
         f"{tag}: final rows differ from the plain running top-k")
    log(f"{tag}: final top-{k} of all {p} columns equal the plain running "
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


# ---------------------------------------------------------------- phase 6

def phase_mp(main, batch=2_000_000, device="cuda"):
    """The multi-process scan's path in one process, on phase 3's table and
    dtable (N=1008, P=101, top-10001, 2,000,000-row batches): K3 on every
    batch, K2 on the fallbacks, and the same top-k, rows and f32 scores, as
    `associate` in all 101 columns (both are exact top-k under (score
    desc, row asc) over the same device arithmetic). device="cpu" and a
    smaller table rehearse the phase without a card."""
    import torch
    from kmersgwas_tpu_torch.ops import score
    from kmersgwas_tpu_torch.parallel import multihost
    from kmersgwas_tpu_torch.pipeline import scan
    cuda = device == "cuda"
    k = 10001
    kw = dict(kmer_len=main["kmer_len"], device=device, n_top=k,
              batch_size=batch, count_patterns=True,
              dtable_cache=main["dtable"])
    args = (main["base"], main["names"], main["y"], main["cols"])
    marks = []
    score.score_batch_t_tilemax.launches = 0
    score.score_batch_t_bmax.launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    per, n_tested, n_patterns = multihost.run_distributed_scan(
        *args, progress=lambda r: marks.append(time.perf_counter()), **kw)
    wall = time.perf_counter() - t0
    k3 = score.score_batch_t_tilemax.launches
    k2 = score.score_batch_t_bmax.launches
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_batches = -(-main["n_tested"] // batch)
    step_ms = [round(1e3 * (b - a), 2) for a, b in zip([t0] + marks, marks)]
    log(f"mp: run_distributed_scan, 1 process: {n_tested} k-mers in "
        f"{len(marks)} steps, {n_tested / (marks[-1] - t0):,.0f} k-mers/s "
        f"over the stream (call to last step); step ms {step_ms} (the "
        f"first includes set-up); wall {wall:.2f} s; K3 score_tilemax "
        f"launches {k3}, K2 score_bmax launches {k2}; peak device memory "
        f"{peak / 2**30:.2f} GiB")
    need(n_tested == main["n_tested"],
         f"mp: n_tested {n_tested} != MAC-passing rows {main['n_tested']}")
    need(k3 >= n_batches or not cuda,
         f"mp: K3 launched {k3} times for {n_batches} batches")
    need(k2 >= 1 or not cuda, "mp: K2 was never launched")
    ref = scan.associate(*args, certify_topk=False, progress=lambda r: None,
                         **kw)
    need(n_patterns == ref.n_patterns,
         f"mp: {n_patterns} patterns, associate {ref.n_patterns}")
    for j, (sc, rw) in enumerate(per):
        need(np.array_equal(rw, ref.rows[j]) and
             np.array_equal(sc, ref.scores[j]),
             f"mp: column {j} differs from associate")
    log(f"mp: all {len(per)} columns equal associate's top-{k} (rows and "
        f"scores), {n_patterns} patterns")
    from kmersgwas_tpu_torch.core import dtable as dt_mod
    planes = np.asarray(dt_mod.DTableReader(main["dtable"]).planes[:batch])
    t0 = time.perf_counter()
    scan._PatternCounter().add(planes)
    log(f"mp: the host's pattern count of one {len(planes)}-row batch "
        f"(count_patterns) takes {time.perf_counter() - t0:.2f} s")
    return dict(k3=k3)


# ---------------------------------------------------------------- phase 7

def phase_mp_cli(workdir, main, n_proc=2, device="cuda", batch=2_000_000,
                 timeout=600):
    """`associate-mp` in n_proc processes over gloo, all on the one card,
    against one process: every output file byte-identical. The two runs
    go at once (n_proc + 1 processes on the card), each with its own
    coordinator port."""
    import socket
    import torch
    if device == "cuda":
        torch.cuda.empty_cache()        # the card is shared with the ranks
    pheno = os.path.join(workdir, "mp.pheno")
    write_phenotypes(pheno, main["cols"], main["names"], main["y"])
    socks = [socket.socket() for _ in range(2)]
    try:                                # two ports, free at once
        for sk in socks:
            sk.bind(("127.0.0.1", 0))
        ports = [sk.getsockname()[1] for sk in socks]
    finally:
        for sk in socks:
            sk.close()
    procs = {}
    t0 = time.perf_counter()
    try:
        for n, port in zip((n_proc, 1), ports):
            out = os.path.join(workdir, f"mp_{n}")
            os.makedirs(out)
            cmd = [sys.executable, "-m", "kmersgwas_tpu_torch.cli",
                   "associate-mp", "-p", pheno, "-t", main["base"],
                   "-k", str(main["kmer_len"]), "-o", out, "-b", "10001",
                   "--batch_size", str(batch), "--pattern_counter",
                   "--device", device, "--dtable_cache", main["dtable"],
                   "--coordinator", f"127.0.0.1:{port}",
                   "--num_processes", str(n)]
            procs[n] = [subprocess.Popen(
                cmd + ["--process_id", str(i)], cwd=ROOT,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for i in range(n)]
        logs = {n: [pr.communicate(timeout=timeout)[0] for pr in ps]
                for n, ps in procs.items()}
    finally:
        for ps in procs.values():       # a failed or hung rank: stop all
            for pr in ps:
                if pr.poll() is None:
                    pr.kill()
                    pr.wait()
    outs = {}
    for n, ps in procs.items():
        for i, (pr, text) in enumerate(zip(ps, logs[n])):
            need(pr.returncode == 0, f"associate-mp {n} processes: rank {i} "
                 f"exited {pr.returncode}:\n{text[-3000:]}")
        log(f"associate-mp --num_processes {n} --device {device}: "
            + "; ".join(t.strip().splitlines()[-1] for t in logs[n]))
        out = os.path.join(workdir, f"mp_{n}")
        outs[n] = {f: open(os.path.join(out, f), "rb").read()
                   for f in sorted(os.listdir(out))}
    log(f"associate-mp: both runs {time.perf_counter() - t0:.1f} s wall")
    a, b = outs[n_proc], outs[1]
    need(sorted(a) == sorted(b), f"associate-mp outputs differ in files")
    diff = [f for f in a if a[f] != b[f]]
    need(not diff, f"associate-mp outputs differ: {diff[:5]}")
    need(sum(f.endswith(".bed") for f in a) == len(main["cols"]),
         "associate-mp: a bed per column missing")
    log(f"associate-mp: {len(a)} output files byte-identical between "
        f"{n_proc} processes sharing the card and 1 process "
        f"({sum(len(v) for v in a.values()) / 2**20:.1f} MiB)")


# ---------------------------------------------------------------- phase 8

class Interrupt(Exception):
    pass


def xnor_oracle(base, n, keep, pairs, chunk=1 << 20):
    """numpy: for each sample pair (i, j), the fraction of kept table rows
    on which samples i and j agree (the reference's XNOR count over the
    number of k-mers used)."""
    wf = (n + 63) // 64
    raw = np.memmap(base + ".table", dtype="<u8", mode="r",
                    offset=TABLE_HEADER.size).reshape(-1, 1 + wf)
    samples = np.unique(pairs)
    col = {int(s): i for i, s in enumerate(samples)}
    agree = np.zeros(len(pairs), np.int64)
    for s in range(0, raw.shape[0], chunk):
        words = np.ascontiguousarray(raw[s:s + chunk][keep[s:s + chunk]])
        bits = np.stack([(words[:, 1 + x // 64] >> np.uint64(x % 64))
                         & np.uint64(1) for x in samples])
        for q, (i, j) in enumerate(pairs):
            agree[q] += int(np.count_nonzero(bits[col[i]] == bits[col[j]]))
    return agree / float(keep.sum())


def phase_kinship(main, workdir, batch=1 << 20, maf=0.05, device="cuda"):
    """The kinship path at full width: `kinship_from_table` on phase 3's
    table (N=1008, 4.2M rows, 2^20-row batches) on the dtable route (phase
    3's cache matches the kinship filter, ceil(1008 * 0.05) = 51) and on the
    raw-table route. Held against the plain accumulator on the same device
    (kinship_gram_plain per batch, int64 host sum), against a numpy XNOR
    count on 64 sampled pairs, and against a run interrupted after 3
    batches and resumed from its checkpoint (taken every 2)."""
    import math
    import torch
    from kmersgwas_tpu_torch.core import dtable as dt_mod
    from kmersgwas_tpu_torch.ops import kinship as kin_ops
    from kmersgwas_tpu_torch.pipeline import kinship as km
    cuda = device == "cuda"
    n, base = main["n"], main["base"]
    need(math.ceil(n * maf) == 51, "the kinship filter differs from phase 3's")
    kw = dict(device=device, maf=maf, batch_size=batch)
    marks = []
    kin_ops.kinship_accumulate.launches = 0
    kin_ops.transpose_bits.launches = 0
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    K = km.kinship_from_table(base, dtable_cache=main["dtable"],
                              progress=lambda r: marks.append(
                                  time.perf_counter()), **kw)
    wall = time.perf_counter() - t0
    launches = kin_ops.kinship_accumulate.launches
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    n_rows = main["n_tested"]
    n_batches = -(-n_rows // batch)
    step_ms = [round(1e3 * (b - a), 2) for a, b in zip([t0] + marks, marks)]
    log(f"kinship: dtable route, {n_rows} rows x N={n} in {len(marks)} "
        f"batches: {n_rows / (marks[-1] - t0):,.0f} rows/s from the call to "
        f"the last batch, wall {wall:.2f} s; batch ms {step_ms} (the first "
        f"includes set-up); K7 kinship_gram launches {launches}; peak device "
        f"memory {peak / 2**30:.2f} GiB")
    need(len(marks) == n_batches, f"kinship: {len(marks)} batches, "
         f"expected {n_batches}")
    need(launches == n_batches or not cuda,
         f"kinship: K7 launched {launches} times for {n_batches} batches")
    need(K.shape == (n, n) and bool(np.isfinite(K).all()),
         f"kinship: matrix {K.shape}")
    transposes = kin_ops.transpose_bits.launches
    if cuda:
        in_fresh_process(f"kinship_split({base!r}, {main['dtable']!r}, "
                         f"{kw!r}, {n_rows / (marks[-1] - t0)!r})")
    # the plain accumulator on the same device, batch by batch
    t0 = time.perf_counter()
    dt = dt_mod.DTableReader(main["dtable"])
    total = np.zeros((n, n), np.int64)
    for s in range(0, dt.hdr.n_rows, batch):
        planes = torch.from_numpy(np.array(
            dt.planes[s:s + batch]).view(np.int32)).to(device)
        g = kin_ops.kinship_gram_plain(planes, planes.shape[0])
        total += g.cpu().numpy().astype(np.int64)[:n, :n]
        del planes, g
    need(dt.hdr.n_rows == n_rows, "kinship: dtable rows differ")
    K_plain = kin_ops.normalize(total, dt.hdr.n_rows)
    need(np.array_equal(K, K_plain),
         f"kinship: {int((K != K_plain).sum())} entries differ from the "
         f"plain accumulator")
    log(f"kinship: equal to the plain accumulator on the card, bit for bit "
        f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    K_raw = km.kinship_from_table(base, **kw)
    need(np.array_equal(K_raw, K), "kinship: the raw-table route differs")
    log(f"kinship: raw-table route equal, wall "
        f"{time.perf_counter() - t0:.2f} s")
    rng = np.random.default_rng(12)
    pairs = rng.choice(n, size=(96, 2), replace=True)
    pairs = pairs[pairs[:, 0] != pairs[:, 1]][:64]
    t0 = time.perf_counter()
    want = xnor_oracle(base, n, main["keep"], pairs)
    got = K[pairs[:, 0], pairs[:, 1]]
    need(np.array_equal(got, want),
         f"kinship: {int((got != want).sum())} of {len(pairs)} sampled pairs "
         f"differ from the numpy XNOR count")
    log(f"kinship: {len(pairs)} sampled pairs equal the numpy XNOR count "
        f"({time.perf_counter() - t0:.1f} s)")
    ck = os.path.join(workdir, "kin_ck")
    calls = []

    def bomb(r):
        calls.append(r)
        if len(calls) == 3:
            raise Interrupt
    try:
        km.kinship_from_table(base, dtable_cache=main["dtable"],
                              checkpoint_path=ck, checkpoint_every=2,
                              progress=bomb, **kw)
        need(False, "kinship: the interrupted run was not interrupted")
    except Interrupt:
        pass
    z = np.load(ck + ".npz")
    need(bytes(z["stream"]).decode() == "dtable"
         and int(z["n_rows"]) == 2 * batch,
         f"kinship: checkpoint holds {int(z['n_rows'])} rows")
    rest = []
    K_res = km.kinship_from_table(base, dtable_cache=main["dtable"],
                                  checkpoint_path=ck, checkpoint_every=2,
                                  progress=rest.append, **kw)
    need(len(rest) == n_batches - 2, f"kinship: resumed over {len(rest)} "
         f"batches")
    need(np.array_equal(K_res, K), "kinship: the resumed matrix differs")
    log(f"kinship: interrupted after 3 batches, resumed from the checkpoint "
        f"of batch 2 over {len(rest)} batches: equal")
    return dict(k7=launches, k7t=transposes, K=K)


def kinship_batch_split(wall_ms, busy_ms, per, frac, label):
    """The device's share of a kinship batch's wall: wall_ms the wall of
    one full batch, busy_ms and per the profiled run's device time in all
    and by event name (device_busy), frac the run's full-batch equivalents
    (a partial batch does less), so busy_ms / frac is one full batch's
    device time. The device works only inside the wall, so the idle share
    must lie in [0, 100] %; a share outside it fails the phase."""
    busy = busy_ms / frac
    tr, gram, h2d = (sum(ms for k, ms in per.items() if key in k) / frac
                     for key in ("kinship_transpose_kernel",
                                 "kinship_gram_kernel", "Memcpy"))
    idle = 100 * (1 - busy / wall_ms)
    need(0.0 <= idle <= 100.0,
         f"kinship: {label}: idle share {idle:.1f} % outside [0, 100] "
         f"(wall {wall_ms:.3f} ms, device busy {busy:.3f} ms a batch)")
    return dict(wall=wall_ms, busy=busy, idle=idle, transpose=tr, gram=gram,
                h2d=h2d)


def kinship_split(base, dtable, kw, path_rate):
    """What bounds the kinship path (run in a new process, in_fresh_process):
    kinship_from_table on the dtable route again, all of it under the
    profiler. A full batch's wall is the whole synchronized run (the
    call's start to torch.cuda.synchronize() after it, set-up included)
    over its full-batch equivalents; against it, one full batch's device
    time (the K7 kernels, host-to-device copies and the rest) and the idle
    share they leave (kinship_batch_split). Beside it, the median interval
    between CUDA events recorded after each batch's work (batches 2 to
    the last full one: when the device finished one batch and the next);
    the copies of later batches run ahead of a batch's kernels, so that
    interval is not held against a batch's device time. Then the host
    feed alone (kinship_feed on its prefetch thread and the staging copy,
    as the bench's kinship feed pass, warm cache) against the path's
    rate."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from kmersgwas_tpu_torch.core import dtable as dt_mod
    from kmersgwas_tpu_torch.pipeline import feed as feed_mod
    from kmersgwas_tpu_torch.pipeline import kinship as km
    batch = kw["batch_size"]
    rows, events = [], []

    def progress(r):
        rows.append(r)
        events.append(torch.cuda.Event(enable_timing=True))
        events[-1].record()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        km.kinship_from_table(base, dtable_cache=dtable, progress=progress,
                              **kw)
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
    n_full = sum(r == batch for r in rows)
    need(n_full >= 3, f"kinship: {n_full} full batches, the split needs 3")
    busy, per = device_busy(prof)
    need(busy > 0, "kinship: no device time in the trace")
    frac = sum(rows) / batch
    sp = kinship_batch_split(1e3 * run_s / frac, busy, per, frac,
                             "the whole run")
    ends = statistics.median(events[i - 1].elapsed_time(events[i])
                             for i in range(1, n_full))
    dt = dt_mod.DTableReader(dtable)
    stage = np.empty((batch, dt.hdr.w32), np.uint32)
    t0 = time.perf_counter()
    for _, r, planes in feed_mod._prefetch(feed_mod.kinship_feed(dt, batch),
                                           depth=2):
        np.copyto(stage[:r], planes)
    feed = dt.hdr.n_rows / (time.perf_counter() - t0)
    busy = sp["busy"]
    k7 = sp["transpose"] + sp["gram"]
    log(f"kinship: the profiled run ({len(rows)} batches) takes "
        f"{run_s:.3f} s from the call to the synchronize after it, "
        f"{sp['wall']:.2f} ms of wall per 2^20-row batch (set-up included); "
        f"the device is busy {busy:.3f} ms a batch (idle {sp['idle']:.1f} "
        f"%): K7 transpose {sp['transpose']:.4f} ms + Gram {sp['gram']:.3f} "
        f"ms ({100 * k7 / sp['wall']:.1f} % of the wall, "
        f"{100 * k7 / busy:.1f} % of the device time), host-to-device "
        f"copies {sp['h2d']:.3f} ms, other {busy - k7 - sp['h2d']:.3f} ms; "
        f"the device finished batches 2-{n_full} {ends:.2f} ms apart "
        f"(median, CUDA events); the host feed alone (kinship_feed + "
        f"staging copy, warm) {feed / 1e6:.1f} M rows/s against the path's "
        f"{path_rate / 1e6:.1f} M rows/s")


# ---------------------------------------------------------------- phase 9

def phase_kinship_cli(workdir, devices=("cuda", "cpu"), n=200,
                      n_rows=200_000):
    """`kinship --device cuda` against `--device cpu` (the CPU's int32
    product) on a 200,000-row N=200 table: stdout byte-identical."""
    base = os.path.join(workdir, "kin_small")
    write_table(base, n, n_rows, 31, seed=6)
    outs = []
    for dev in devices:
        cmd = [sys.executable, "-m", "kmersgwas_tpu_torch.cli", "kinship",
               "-t", base, "--maf", "0.05", "--batch_size", "65536",
               "--device", dev]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True,
                              timeout=600)
        need(proc.returncode == 0, f"kinship --device {dev} failed:\n"
             f"{proc.stderr.decode(errors='replace')[-3000:]}")
        log(f"kinship --device {dev}: {len(proc.stdout)} bytes of stdout "
            f"({time.perf_counter() - t0:.1f} s)")
        outs.append(proc.stdout)
    need(outs[0] == outs[1], "kinship CLI stdout differs between devices")
    need(len(outs[0].splitlines()) == n, "kinship CLI: wrong row count")
    log(f"kinship cli: stdout byte-identical between --device {devices[0]} "
        f"and --device {devices[1]}")


# ---------------------------------------------------------------- phase 10

def phase_kinship_mp(workdir, main, kin, n_proc=2, device="cuda",
                     batch=1 << 20, timeout=600):
    """`kinship-mp` in n_proc processes over gloo, all on the one card,
    each over its span dtable: process 0's TSV byte-identical to
    write_kinship of phase 8's one-process matrix."""
    import socket
    import torch
    from kmersgwas_tpu_torch.pipeline import kinship as km
    if device == "cuda":
        torch.cuda.empty_cache()        # the card is shared with the ranks
    ref = os.path.join(workdir, "kin_ref.tsv")
    km.write_kinship(ref, kin["K"])
    out = os.path.join(workdir, "kin_mp.tsv")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    cmd = [sys.executable, "-m", "kmersgwas_tpu_torch.cli", "kinship-mp",
           "-t", main["base"], "--maf", "0.05", "--batch_size", str(batch),
           "-o", out, "--device", device, "--dtable_cache", main["dtable"],
           "--coordinator", f"127.0.0.1:{port}", "--num_processes",
           str(n_proc)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process_id", str(i)], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(n_proc)]
    try:
        logs = [pr.communicate(timeout=timeout)[0] for pr in procs]
    finally:
        for pr in procs:                # a failed or hung rank: stop all
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for i, (pr, text) in enumerate(zip(procs, logs)):
        need(pr.returncode == 0, f"kinship-mp: rank {i} exited "
             f"{pr.returncode}:\n{text[-3000:]}")
    log(f"kinship-mp --num_processes {n_proc} --device {device}: "
        f"{time.perf_counter() - t0:.1f} s wall; "
        + "; ".join(t.strip().splitlines()[-1] for t in logs))
    a, b = open(out, "rb").read(), open(ref, "rb").read()
    need(a == b, "kinship-mp TSV differs from the one-process kinship")
    log(f"kinship-mp: {len(a) / 2**20:.1f} MiB TSV byte-identical between "
        f"{n_proc} processes sharing the card and the one-process matrix")


# ---------------------------------------------------------------- phase 12

def phase_score_batch(rows=2_097_152, n=1008, p=101, n_check=4096,
                      device="cuda"):
    """`score_batch` (K5), the row-major score function, on one flagship
    batch of Gaussian phenotypes at "highest": (R, P), finite, and within
    the RTOL bound of a numpy f64 computation on 4096 sampled rows.
    Smaller arguments and device="cpu" rehearse the phase without a
    card."""
    import torch
    from kmersgwas_tpu_torch.ops import bitplanes, score
    mc = 5
    packed, pc, yp, ysum = make_batch(rows, n, p, seed=21, pad_rows=0,
                                      gaussian=True, device=device)
    score.score_batch.launches = 0
    sc = score.score_batch(packed, pc, yp, ysum, n_used=n, min_count=mc,
                           precision="highest")
    if device == "cuda":
        torch.cuda.synchronize()
    launches = score.score_batch.launches
    need(launches == 1 or device != "cuda",
         f"score_batch: K5 launched {launches} times")
    need(sc.shape == (rows, p) and bool(torch.isfinite(sc).all()),
         f"score_batch: shape {tuple(sc.shape)} or non-finite values")
    idx = torch.from_numpy(np.random.default_rng(3).choice(
        rows, n_check, replace=False)).to(device)
    bits = bitplanes.unpack_bits(packed[idx], torch.float64).cpu().numpy()
    y = yp.double().cpu().numpy()
    n1 = bits.sum(axis=1)[:, None]
    r = n * (bits @ y) - n1 * y.sum(axis=0)[None, :]
    denom = n * n1 - n1 * n1
    with np.errstate(divide="ignore", invalid="ignore"):
        want = np.where(denom > 0, r * r / denom, 0.0)
    want = np.where((n1 >= mc) & (n - n1 >= mc), want, 0.0)
    got = sc[idx].double().cpu().numpy()
    d = np.abs(got - want)
    bound = RTOL * (np.abs(want) + np.abs(want).max(axis=0, keepdims=True))
    need(bool((d <= bound).all()), f"score_batch: {int((d > bound).sum())} "
         f"scores off the f64 oracle by up to {d.max():.3g}")
    log(f"score_batch: ({rows}, {p}) scores, K5 score_rows launches "
        f"{launches}; {n_check} sampled rows within {RTOL} of the f64 "
        f"oracle (max abs diff {d.max():.3g})")
    return dict(k5=launches)


# ---------------------------------------------------------------- phase 13

def phase_gen(rows=1 << 21, w32=32):
    """K6 (gen_planes) against gen_planes_plain on the card. -> (kernel ms,
    plain ms) at (rows, w32)."""
    import torch
    from kmersgwas_tpu_torch.ops import bitplanes, gen
    dev = torch.device("cuda")
    prev = None
    for n_rows, seed, step in ((rows, 1 << 20, 0), (rows, 1 << 20, 1),
                               (rows, 1_000_003, 1103), (rows - 37, 5, 7)):
        planes, pc = gen.gen_planes(n_rows, w32, seed, step, dev)
        torch.cuda.synchronize()
        want, want_pc = gen.gen_planes_plain(
            torch.arange(n_rows, device=dev), w32, seed, step)
        tag = f"gen_planes ({n_rows}, {w32}) seed {seed} step {step}"
        need(torch.equal(planes, want), f"{tag}: planes != plain, "
             f"{int((planes != want).sum())} words differ")
        need(torch.equal(pc, want_pc), f"{tag}: popcounts != plain")
        need(torch.equal(pc, bitplanes.popcount_rows(planes)),
             f"{tag}: popcounts != a bit count of the planes")
        if prev is not None and prev[0] == seed:
            need(not torch.equal(planes, prev[1]),
                 f"{tag}: equal to the step before")
        # density of every bit position (2^21 rows: 2e-3 is 5.8 sigma)
        ones = torch.stack([((planes >> b) & 1).sum(dim=0)
                            for b in range(32)]).double() / n_rows
        dev_max = float((ones - 0.5).abs().max())
        need(dev_max <= 2e-3, f"{tag}: a bit position's density is off 0.5 "
             f"by {dev_max:.2e}")
        log(f"  {tag}: bit-equal to plain; max density deviation of the "
            f"{w32 * 32} bit positions {dev_max:.2e}")
        prev = (seed, planes)
        del planes, pc, want, want_pc, ones
    times = (cuda_ms(lambda: gen.gen_planes(rows, w32, 1, 2, dev)),
             cuda_ms(lambda: gen.gen_planes_plain(
                 torch.arange(rows, device=dev), w32, 1, 2), reps=3))
    log(f"K6 gen_planes ({rows}, {w32}): kernel {times[0]:.3f} ms, plain "
        f"{times[1]:.3f} ms (median CUDA-event times)")
    in_fresh_process(f"gen_kernel_ms([({rows}, {w32}, True)])")
    return dict(times=times, rows=rows, w32=w32)


def kernel_ms_in_order(events, jobs, reps):
    """{label: ms per call} from a profile's device events (name, start,
    duration in us) of `jobs` (label, name_part) run in turn, `reps` calls
    each: each job takes the next `reps` kernels whose names hold its
    name_part, in launch order. Raises where a job finds fewer."""
    events = sorted(events, key=lambda ev: ev[1])
    out, i = {}, 0
    for label, part in jobs:
        got = []
        while len(got) < reps and i < len(events):
            if part in events[i][0]:
                got.append(events[i][2])
            i += 1
        need(len(got) == reps, f"{label}: {len(got)} of {reps} {part} "
             "kernels in the trace")
        out[label] = sum(got) / reps / 1e3
    return out


def profiled_ms(jobs, reps=5):
    """{label: device ms per call} of each job (label, fn, name_part): the
    kernels whose names hold name_part, by the profiler. One profiler
    session holds every job, `reps` calls each in turn after a warm-up
    call of each (on the card, a later session of a process has lost its
    kernels where the first held them)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _, fn, _ in jobs:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _, fn, _ in jobs:
            for _ in range(reps):
                fn()
        torch.cuda.synchronize()
    events = [(e.name, e.time_range.start, e.time_range.elapsed_us())
              for e in prof.events() if e.device_type == DeviceType.CUDA]
    return kernel_ms_in_order(events, [(lb, part) for lb, _, part in jobs],
                              reps)


def gen_jobs(shapes):
    """profiled_ms's jobs for K6 at each (rows, w32, popcount)."""
    import torch
    from kmersgwas_tpu_torch.ops import gen
    dev = torch.device("cuda")

    def job(rows, w32, pcnt):
        return (f"K6 gen_planes ({rows}, {w32}) popcount={pcnt}",
                lambda: gen.gen_planes(rows, w32, 1, 2, dev, popcount=pcnt),
                "gen_planes_")
    return [job(*shape) for shape in shapes]


def log_kernel_ms(jobs, reps=5):
    """One line per job: its kernel by the profiler (profiled_ms) beside its
    whole call by CUDA events (run in a new process, in_fresh_process)."""
    kern = profiled_ms(jobs, reps)
    for label, fn, _ in jobs:
        log(f"{label}: kernel {kern[label]:.4f} ms by the profiler, whole "
            f"call {cuda_ms(fn):.4f} ms (CUDA events) in a new process")


def gen_kernel_ms(shapes):
    """K6's kernel alone by the profiler at each (rows, w32, popcount) of
    `shapes`, beside its whole call (run in a new process,
    in_fresh_process)."""
    log_kernel_ms(gen_jobs(shapes))


# ---------------------------------------------------------------- phase 14

def rescore_kept(run, col=0, operand=False):
    """The final kept rows of column `col` of a bench run, each regenerated
    alone from (seed, step, row) by the plain generator on the host and
    scored in f64 by the step's formula (the popcount counts every lane,
    as the generator's does). operand: take the product with the
    phenotypes the GEMM multiplies at precision "default" (rounded to
    bf16), the column sum with the f32 ones, as the kernels do; else both
    with the f32 ones. -> (kept f32 scores, f64 scores)."""
    import torch
    from kmersgwas_tpu_torch.ops import gen, scanstep, topk
    final = scanstep.flush_buffered(run.state)
    rows = topk.decode_rows(final.row_lo.cpu().numpy(),
                            final.row_hi.cpu().numpy())[col]
    step, r = np.divmod(rows, run.rows)
    n = run.y.shape[0]
    w32 = -(-n // 128) * 4
    planes, pc = gen.gen_planes_plain(torch.from_numpy(r), w32, run.seed,
                                      torch.from_numpy(step))
    bits = np.unpackbits(planes.numpy().view(np.uint8), axis=1,
                         bitorder="little").astype(np.float64)
    y = np.zeros(w32 * 32)
    ycol = torch.from_numpy(np.ascontiguousarray(run.y[:, col]))
    ysum = float(ycol.double().sum())
    if operand:
        ycol = ycol.to(torch.bfloat16).to(torch.float32)
    y[:n] = ycol.numpy().astype(np.float64)
    n1 = pc.numpy().astype(np.float64)
    num = n * (bits @ y) - n1 * ysum
    return final.scores[col].cpu().numpy(), num * num / (n * n1 - n1 * n1)


def phase_bench(workdir):
    """The port's bench at its defaults on the card, then its streaming
    and kinship-streaming modes on the same BENCH_FEED_ROWS-row synthetic
    table."""
    from kmersgwas_tpu_torch import bench
    from kmersgwas_tpu_torch.ops import gen, score
    from kmersgwas_tpu_torch.pipeline.scan import CERTIFY_EPS
    gen.gen_planes.launches = 0
    score.score_batch_t_topw.launches = 0
    score.score_batch_t_bmax.launches = 0
    t0 = time.perf_counter()
    line, run = bench.main(feed_rows=BENCH_FEED_ROWS, workdir=workdir)
    wall = time.perf_counter() - t0
    k6 = gen.gen_planes.launches
    k1 = score.score_batch_t_topw.launches
    k2 = score.score_batch_t_bmax.launches
    log(f"bench: {run.steps} steps of {run.rows} rows in {wall:.1f} s "
        f"(table and feed included); median step {line['median_step_ms']} "
        f"ms, {line['value']:,} k-mers/s, mfu {line['mfu']}; ramp windows "
        f"{line['ramp_window_ms']} ms; branches {run.counts}; K6 gen_planes "
        f"launches {k6}, K1 score_topw {k1}, K2 score_bmax {k2}")
    need(k6 == run.steps, f"bench: K6 launched {k6} times for {run.steps} "
         "steps")
    need(k1 >= run.steps, f"bench: K1 launched {k1} times for {run.steps} "
         "steps")
    need(k2 >= 1, "bench: K2 was never launched")
    need(len(line["ramp_window_ms"]) < 24,
         f"bench: the ramp ran to its cap: {line['ramp_window_ms']}")
    kept, exact = rescore_kept(run)
    err = np.abs(kept - exact) / np.abs(exact)
    need(bool(np.isfinite(kept).all()) and bool((err <= CERTIFY_EPS).all()),
         f"bench: kept scores of column 0 off their f64 re-score by up to "
         f"{err.max():.3g} (CERTIFY_EPS {CERTIFY_EPS})")
    log(f"bench: all {len(kept)} kept rows of column 0, regenerated alone "
        f"and re-scored in f64, within {err.max():.3g} of their kept score "
        f"(CERTIFY_EPS {CERTIFY_EPS})")
    del run
    st = bench.streaming(n_rows=BENCH_FEED_ROWS, workdir=workdir)
    need(st["n_tested"] > 0 and st["value"] > 0,
         f"bench --streaming: {st}")
    kn = bench.kinship_streaming(n_rows=BENCH_FEED_ROWS, workdir=workdir)
    need(kn["value"] > 0 and kn["end_to_end_rows_per_sec"] > 0,
         f"bench --kinship-streaming: {kn}")
    sub = st["sub_stage_seconds"]
    log(f"bench --streaming: {st['n_tested']} rows; the stream sub-stage "
        f"(feed, copy, steps) {sub['stream']} s = "
        f"{st['n_tested'] / max(sub['stream'], 1e-9):,.0f} rows/s; end to "
        f"end {st['value']:,} k-mers/s, set-up and the winner fetch "
        f"included (sub-stages {sub}); --kinship-streaming: feed "
        f"{kn['value']:,} rows/s, end to end "
        f"{kn['end_to_end_rows_per_sec']:,} rows/s (first-batch set-up "
        "included)")
    return dict(k6=k6, line=line)


# ---------------------------------------------------------------- phase 15

def phase_at_scale(workdir):
    """The at-scale stream at full size: it raises unless the resume is
    bit-exact and every planted id above 2^31 comes back with its f64
    score."""
    from kmersgwas_tpu_torch.ops import gen, score
    from kmersgwas_tpu_torch.tools import at_scale_stream as ats
    gen.gen_planes.launches = 0
    score.score_batch_t_topw.launches = 0
    t0 = time.perf_counter()
    res = ats.main(out=os.path.join(workdir, "at_scale.json"))
    wall = time.perf_counter() - t0
    k6, k1 = gen.gen_planes.launches, score.score_batch_t_topw.launches
    log(f"at-scale: {res['total_rows']:,} rows, continuous "
        f"{res['wall_seconds_continuous']} s ({res['rows_per_sec_continuous']:,}"
        f" rows/s), resumed half {res['wall_seconds_resumed_half']} s, "
        f"{wall:.1f} s in all; planted {res['planted_ids']}, recovered "
        f"{res['n_recovered']}; max id in the top-k "
        f"{res['max_row_id_in_topk']:,}; K6 launches {k6}, K1 {k1}")
    need(res["resume_bit_exact"], "at-scale: the resume differs")
    need(res["n_recovered"] == len(res["planted_ids"])
         and all(i > 2**31 for i in res["recovered"]),
         f"at-scale: recovered {res['recovered']}")
    need(res["planted_scores_match_host_f64"],
         "at-scale: planted scores differ from f64")
    need(res["max_row_exceeds_2p31"], "at-scale: no top-k id past 2^31")
    need(k6 > 0 and k1 >= k6, f"at-scale: K6 launched {k6}, K1 {k1} times")
    return dict(k6=k6)


# ---------------------------------------------------------------- phase 16

def phase_probe_kernels(rows=1 << 21, n=1008, p=101):
    """K9 through the exp_kernel tool, K8 on one flagship batch, K6 at the
    probes' generator shapes. -> the launches of the tool's run, errors
    and times."""
    import torch
    from kmersgwas_tpu_torch.ops import gen, score
    from kmersgwas_tpu_torch.ops import tilereduce as tred
    from kmersgwas_tpu_torch.tools import exp_kernel as ek
    dev = torch.device("cuda")
    # the tool as a user runs it: the twenty cases at (P_PAD 104, NT 128,
    # TR 2048) on its tie-heavy plane; it raises unless every case's
    # planes equal their plain versions and the JAX kernel's numpy function
    tred.tile_reduce.launches = tred.tile_topc.launches = 0
    recs = ek.main(device="cuda")
    k9 = (tred.tile_reduce.launches, tred.tile_topc.launches)
    need(len(recs) == 20 and all(r["equal_plain"] and r["equal_numpy"]
                                 for r in recs), "K9: a case differs")
    log("K9 exp_kernel: 20 cases bit-equal to plain and to the JAX "
        "kernels' functions; kernel/plain ms " + ", ".join(
            f"{r['case']} {r['kernel_ms']:.3f}/{r['plain_ms']:.3f}"
            for r in recs))
    fold = [r["fold_equals_first_argmax_frac"] for r in recs
            if r["case"] in ("vi", "vif")]
    log(f"K9: the halving fold equals the first argmax in {fold} of tiles "
        f"(tie-heavy plane); tile_reduce launches {k9[0]}, tile_topc {k9[1]}")
    x = torch.from_numpy(ek.tie_heavy()).to(dev)
    th = torch.zeros(ek.P_PAD, device=dev)
    m1 = tred.tile_reduce(x, None, n_tiles=ek.NT, planes=("m1",))["m1"]
    t9 = (cuda_ms(lambda: tred.tile_reduce(x, th, n_tiles=ek.NT)),
          cuda_ms(lambda: tred.tile_reduce_plain(x, th, n_tiles=ek.NT),
                  reps=3),
          cuda_ms(lambda: torch.max(x.view(ek.P_PAD, ek.NT, ek.TR), dim=2)),
          cuda_ms(lambda: tred.tile_topc(m1)),
          cuda_ms(lambda: tred.tile_topc_plain(m1), reps=3),
          cuda_ms(lambda: torch.sort(m1, dim=1, descending=True,
                                     stable=True)))
    log(f"K9 tile_reduce (all seven planes, {tuple(x.shape)}): kernel "
        f"{t9[0]:.3f} ms, plain {t9[1]:.3f} ms, torch.max(dim=2) "
        f"{t9[2]:.3f} ms; tile_topc ({tuple(m1.shape)}): whole call "
        f"{t9[3]:.4f} ms, plain {t9[4]:.3f} ms, torch.sort(stable) "
        f"{t9[5]:.4f} ms (median CUDA-event times)")
    in_fresh_process("probe_kernels_ms()")

    kw = dict(n_used=n, min_count=51, tile_rows=4096, w=128)
    err8, t8 = 0.0, None
    for gaussian, prec in ((False, "default"), (True, "highest")):
        packed, pc, yp, ysum = make_batch(rows, n, p, 7, 0, gaussian)
        ps = score.scores_t_plain(packed, pc, yp, ysum, n_used=n,
                                  min_count=51, precision=prec)
        scale = col_scale(ps)
        q = torch.topk(ps, 100, dim=1).values[:, -1].contiguous()
        del ps
        args = (packed, pc, yp, ysum, q)
        got = score.score_batch_t_parity(*args, precision=prec, **kw)
        torch.cuda.synchronize()
        want = score.parity_plain(*args, precision=prec, **kw)
        tag = f"K8 score_parity ({'gauss' if gaussian else 'dyadic'} {prec})"
        if not gaussian:
            need(all(torch.equal(a, b) for a, b in zip(got, want)),
                 f"{tag}: != parity_plain")
            t8 = (cuda_ms(lambda: score.score_batch_t_parity(
                      *args, precision=prec, **kw)),
                  cuda_ms(lambda: score.parity_plain(
                      *args, precision=prec, **kw), reps=3))
        for i in (0, 2):
            fin = torch.isfinite(want[i])
            need(torch.equal(torch.isfinite(got[i]), fin),
                 f"{tag}: -inf slots differ")
            d = torch.where(fin, (got[i] - want[i]).abs(), 0.0)
            err8 = max(err8, float(d.max()))
            need(bool((d <= RTOL * (torch.where(fin, want[i].abs(), 0.0)
                                    + scale)).all()),
                 f"{tag}: values off by {float(d.max())}")
        log(f"{tag}: lists A/B at tile 4096, w 128 checked against plain; "
            f"ok columns {int(got[4].sum())}/{p}")
        del packed, pc, got, want
        torch.cuda.empty_cache()
    log(f"K8 score_parity (R={rows}, N={n}, P={p}): kernel {t8[0]:.3f} ms, "
        f"plain {t8[1]:.3f} ms; max abs err (gauss, highest) {err8:.3g}")
    log_select_paths(lambda: score.score_batch_t_parity(
        *args, precision="default", **kw), "K8 at tile 4096, w 128")

    # K10: the probes' generators, (rows, 32) with and without popcounts
    for g_rows in (1 << 19, 1 << 20, 1 << 21, 1 << 22, 1 << 23):
        for pcnt in (True, False):
            out = gen.gen_planes(g_rows, 32, 1 << 20, 5, dev, popcount=pcnt)
            planes = out[0] if pcnt else out
            want, want_pc = gen.gen_planes_plain(
                torch.arange(g_rows, device=dev), 32, 1 << 20, 5)
            need(torch.equal(planes, want)
                 and (not pcnt or torch.equal(out[1], want_pc)),
                 f"gen_planes ({g_rows}, 32) popcount={pcnt}: != plain")
            ms = cuda_ms(lambda: gen.gen_planes(g_rows, 32, 1 << 20, 5, dev,
                                                popcount=pcnt))
            log(f"  K10 gen_planes ({g_rows}, 32) popcount={pcnt}: "
                f"bit-equal to plain, {ms:.3f} ms")
            del out, planes, want, want_pc
    return dict(k9=k9, t9=t9, err8=err8, t8=t8)


# the probes' generator shapes (K10): (rows, w32, popcount)
PROBE_GEN_SHAPES = tuple((1 << k, 32, pcnt) for k in range(19, 24)
                         for pcnt in (True, False))


def probe_kernels_ms():
    """Phase 16's kernels alone by the profiler (run in a new process,
    in_fresh_process), each beside its whole call by CUDA events:
    tile_reduce (all seven planes) on the exp_kernel tool's plane, tile_topc
    on its tile maxima, K8's select launch (its two lists of the flagship
    batch at tile 4096, w 128) and K6 at the probes' generator shapes."""
    import torch
    from kmersgwas_tpu_torch.ops import score
    from kmersgwas_tpu_torch.ops import tilereduce as tred
    from kmersgwas_tpu_torch.tools import exp_kernel as ek
    x = torch.from_numpy(ek.tie_heavy()).to("cuda")
    th = torch.zeros(ek.P_PAD, device="cuda")
    m1 = tred.tile_reduce(x, None, n_tiles=ek.NT, planes=("m1",))["m1"]
    rows, n, p = 1 << 21, 1008, 101
    packed, pc, yp, ysum = make_batch(rows, n, p, 7, 0, False)
    th8 = torch.full((p,), float("inf"), device="cuda")
    log_kernel_ms([
        (f"K9 tile_reduce (all seven planes, {tuple(x.shape)})",
         lambda: tred.tile_reduce(x, th, n_tiles=ek.NT),
         "tile_reduce_kernel"),
        (f"K9 tile_topc ({tuple(m1.shape)})", lambda: tred.tile_topc(m1),
         "tile_topc_kernel"),
        (f"K8's select launch (R={rows}, P={p}, tile 4096, w 128; bound "
         f"{select_bound_ms(rows, p, 128, 4096, 2):.4f} ms)",
         lambda: score.score_batch_t_parity(packed, pc, yp, ysum, th8,
                                            n_used=n, min_count=51,
                                            tile_rows=4096, w=128),
         "topw_select"),
        *gen_jobs(PROBE_GEN_SHAPES)])


# ---------------------------------------------------------------- phase 17

# the probes' headline variants at cut window counts (n_warm, n_ramp,
# n_windows); P=1009 runs 4 ramp windows, the others 1
PROBE_WINDOWS = {"prof_r5_pscale": (1, 4, 2)}


def phase_probes():
    """Each probe's headline variant through the probe tool on the card,
    window counts cut. -> K8's launches on its variant."""
    import torch
    from kmersgwas_tpu_torch import bench
    from kmersgwas_tpu_torch.ops import gen, score
    from kmersgwas_tpu_torch.pipeline.scan import CERTIFY_EPS
    from kmersgwas_tpu_torch.tools import probes
    dev = torch.device("cuda")
    card = bench.card_line(dev)
    k8 = 0
    for probe, name in probes.HEADLINE.items():
        v = probes.variant(probe, name)
        n_warm, n_ramp, n_win = PROBE_WINDOWS.get(probe, (1, 1, 2))
        gen.gen_planes.launches = score.score_batch_t_parity.launches = 0
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        run = probes.run_variant(v, dev, card, n_warm=n_warm, n_ramp=n_ramp,
                                 n_windows=n_win)
        wall = time.perf_counter() - t0
        rec = run.record
        steps = v.s * (n_warm + n_ramp + n_win)
        tag = f"probe {probe} {name}"
        need(math.isfinite(rec["median_step_ms"])
             and rec["median_step_ms"] > 0, f"{tag}: {rec}")
        need(gen.gen_planes.launches == steps,
             f"{tag}: K6 launched {gen.gen_planes.launches} times for "
             f"{steps} steps")
        if v.timed == "step":
            timed = sum(rec["branches"].get(b, 0)
                        for b in ("narrow", "wide", "fallback"))
            need(run.steps == steps and timed == v.s * n_win,
                 f"{tag}: {run.steps} steps, branches {rec['branches']}")
        if v.kernel == "score_parity":
            k8 = score.score_batch_t_parity.launches
            need(k8 == steps, f"{tag}: K8 launched {k8} times")
        log(f"{tag}: P={v.p}, {v.rows} rows per step, {steps} steps in "
            f"{wall:.1f} s; median step {rec['median_step_ms']:.3f} ms, "
            f"{rec['tests_per_s']:.4g} tests/s; ramp branches "
            f"{rec['ramp_branches']}, timed {rec['branches']}; peak "
            f"{rec['peak_device_gib']:.2f} GiB")
        if probe == "prof_r5_pscale":
            for col in (0, v.p - 1):
                kept, exact = rescore_kept(run, col, operand=True)
                err = np.abs(kept - exact) / np.abs(exact)
                need(bool(np.isfinite(kept).all())
                     and bool((err <= CERTIFY_EPS).all()),
                     f"{tag}: kept scores of column {col} off their f64 "
                     f"re-score by up to {err.max():.3g}")
                _, f32y = rescore_kept(run, col)
                err32 = np.abs(kept - f32y) / np.abs(f32y)
                log(f"{tag}: all {len(kept)} kept rows of column {col}, "
                    f"regenerated alone and re-scored in f64, within "
                    f"{err.max():.3g} of their kept score with the bf16 "
                    f"phenotypes the GEMM multiplies (CERTIFY_EPS "
                    f"{CERTIFY_EPS}); {err32.max():.3g} with the f32 ones "
                    "(the bf16 rounding, CERTIFY_EPS's subject)")
        del run
        torch.cuda.empty_cache()
    return dict(k8=k8)


# ---------------------------------------------------------------- phase 18

class Capture:
    """Wraps `module.name` for one run: each call goes through unchanged
    and its result is kept, in call order."""

    def __init__(self, module, name):
        self.module, self.name, self.calls = module, name, []

    def __enter__(self):
        fn = self.orig = getattr(self.module, self.name)

        def wrapper(*a, **k):
            r = fn(*a, **k)
            self.calls.append(r)
            return r
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


GWAS_DUPLICATES = 8


def write_gwas_phenotype(path, names, seed):
    """One Gaussian phenotype over every accession in table order, then a
    second value for the first GWAS_DUPLICATES accessions, which the
    pipeline averages -> the averaged values (n,), as average_phenotypes
    computes them. Values are written in full (repr)."""
    rng = np.random.default_rng(seed)
    y = rng.normal(size=len(names))
    extra = rng.normal(size=GWAS_DUPLICATES)
    with open(path, "w") as f:
        f.write("accession_id\tphenotype_value\n")
        for a, v in zip(names + names[:GWAS_DUPLICATES],
                        np.concatenate([y, extra])):
            f.write(f"{a}\t{float(v)!r}\n")
    y[:GWAS_DUPLICATES] = [(0.0 + a + b) / 2 for a, b in
                           zip(y[:GWAS_DUPLICATES], extra)]
    return y


def ml_lrt_oracle(x, y, d, U, n_grid=64):
    """scipy float64 oracle of one variant's ML-LRT p-value, independent
    of the port's closed forms: the profile LL of each model by weighted
    least squares (lstsq on the rotated, sqrt(1/v)-scaled data) at a given
    lambda, maximized over log10 lambda in [-5, 5] by a grid and a bounded
    Brent search (xatol 1e-10) in the grid maximum's bracket."""
    from scipy.optimize import minimize_scalar
    from scipy.stats import chi2
    n = len(y)
    yt = U.T @ y

    def best(X):
        Xt = U.T @ X

        def ll(lg):
            v = 10.0 ** lg * d + 1.0
            s = 1.0 / np.sqrt(v)
            beta = np.linalg.lstsq(Xt * s[:, None], yt * s, rcond=None)[0]
            r = (yt - Xt @ beta) * s
            return 0.5 * (n * (np.log(n / (2 * np.pi)) - 1.0
                               - np.log(r @ r)) - np.log(v).sum())
        grid = np.linspace(-5.0, 5.0, n_grid)
        lls = [ll(g) for g in grid]
        i = int(np.argmax(lls))
        r = minimize_scalar(lambda g: -ll(g), method="bounded",
                            bounds=(grid[max(i - 1, 0)],
                                    grid[min(i + 1, n_grid - 1)]),
                            options={"xatol": 1e-10})
        return max(-r.fun, lls[i])
    one = np.ones((n, 1))
    lrt = 2.0 * (best(np.hstack([one, x[:, None]])) - best(one))
    return float(chi2.sf(max(lrt, 0.0), 1))


def read_table_tsv(path):
    """A phenotype-style TSV -> (header, accessions, values)."""
    with open(path) as f:
        head = f.readline().rstrip("\n").split("\t")
        rows = [ln.rstrip("\n").split("\t") for ln in f if ln.strip()]
    return head, [r[0] for r in rows], np.array(
        [[float(v) for v in r[1:]] for r in rows])


def read_assoc(path):
    """assoc.txt(.gz) -> (rs names, af, l_mle, p_lrt)."""
    import gzip
    op = gzip.open if path.endswith(".gz") else open
    with op(path, "rt") as f:
        rows = [ln.rstrip("\n").split("\t") for ln in f][1:]
    return ([r[1] for r in rows],
            *(np.array([float(r[c]) for r in rows]) for c in (6, 7, 8)))


def phase_gwas(main, workdir, kin, k=10001, n_perm=100, batch=2_000_000,
               device="cuda"):
    """`run_gwas` at the flagship on phase 3's table (N=1008, ~4.2M rows,
    k=31): one Gaussian phenotype with GWAS_DUPLICATES accessions given
    twice, 100 permutations, top-10001, 2M-row batches, kinship from the
    table (K7) on the dtable route, certify_topk; once with the LMM's
    device32 backend and once with host64 (float64 on the card). Held to
    phase 8's kinship, a numpy recomputation of the transform, the f64
    oracle's top-k, a scipy oracle of the LMM, the order statistic of
    best_pvals and the pass files' rule. Smaller arguments and
    device="cpu" rehearse the phase without a card."""
    import contextlib
    import scipy.linalg
    import torch
    from kmersgwas_tpu_torch.ops import kinship as kin_ops
    from kmersgwas_tpu_torch.ops import score
    from kmersgwas_tpu_torch.pipeline import gwas as gwas_mod
    from kmersgwas_tpu_torch.pipeline import kinship as km
    cuda = device == "cuda"
    base, names, n = main["base"], main["names"], main["n"]
    pheno = os.path.join(workdir, "gwas.pheno")
    y = write_gwas_phenotype(pheno, names, seed=18)
    counters = (score.score_batch_t_topw, score.score_batch_t_bmax,
                kin_ops.kinship_accumulate, kin_ops.transpose_bits)
    launches = [0] * len(counters)
    runs = {}
    t_phase = time.perf_counter()
    for backend in ("device32", "host64"):
        if os.path.exists(base + ".kinship"):
            os.remove(base + ".kinship")     # each run computes kinship
        out = os.path.join(workdir, f"gwas_{backend}")
        cfg = gwas_mod.GWASConfig(
            pheno_path=pheno, kmers_table=base, outdir=out,
            kmer_len=main["kmer_len"], n_kmers=k, n_permutations=n_perm,
            batch_size=batch, dtable_cache=main["dtable"], device=device,
            lmm_backend=backend, certify_topk=True)
        with contextlib.ExitStack() as stack:
            cap = {name: stack.enter_context(Capture(mod, name))
                   for mod, name in (
                       (gwas_mod.transform_mod, "transform_and_permute"),
                       (gwas_mod.scan_mod, "associate"),
                       (gwas_mod.lmm_mod, "lmm_scan_columns_packed"))}
            for c in counters:
                c.launches = 0
            if cuda:
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = gwas_mod.run_gwas(cfg)
            wall = time.perf_counter() - t0
            run_launches = [c.launches for c in counters]
        launches = [a + b for a, b in zip(launches, run_launches)]
        tr = cap["transform_and_permute"].calls[0]
        sr = cap["associate"].calls[0]
        lmm = cap["lmm_scan_columns_packed"].calls
        p = np.concatenate([r.p_lrt.cpu().numpy().astype(np.float64)
                            for r in lmm])
        runs[backend] = dict(res=res, tr=tr, sr=sr, p=p, out=out)
        log(f"gwas {backend}: wall {wall:.2f} s; stage_seconds "
            + json.dumps({a: round(b, 3) for a, b in
                          res.stage_seconds.items()}))
        log(f"gwas {backend}: K1 {run_launches[0]}, K2 {run_launches[1]}, "
            f"K7 Gram {run_launches[2]} and transpose {run_launches[3]} "
            f"launches; {res.n_tested} k-mers tested; h2 "
            f"{res.heritability:.4f}; thresholds {res.thresholds}; "
            f"{len(res.pass_5per)} k-mers pass 5 %")
        need(not cuda or min(run_launches) > 0,
             f"gwas {backend}: a kernel of the path was not launched: "
             f"{run_launches}")
        need(p.shape == (1 + n_perm, k) and bool(np.isfinite(p).all()),
             f"gwas {backend}: LMM p-values {p.shape}")
        summary = json.loads(open(os.path.join(out, "summary.json")).read())
        need(summary["lmm_backend"] == backend,
             f"gwas: summary.json says {summary['lmm_backend']}")
        # kinship: phase 8's matrix, bit for bit (the cache holds reprs)
        K_full = km.read_kinship(base + ".kinship")
        need(np.array_equal(K_full, kin["K"]),
             f"gwas {backend}: kinship differs from phase 8's in "
             f"{int((K_full != kin['K']).sum())} entries")
        # transform: the averaged phenotype, and V^-1 by a numpy Cholesky
        K = np.loadtxt(os.path.join(out, "pheno.kinship"), delimiter="\t")
        need(np.allclose(tr.phenotypes[:, 0], y - y.mean(), rtol=0,
                         atol=1e-12), "gwas: the averaged phenotype differs")
        V = tr.vg * K + tr.ve * np.eye(n)
        want = scipy.linalg.cho_solve((np.linalg.cholesky(V), True),
                                      tr.phenotypes)
        rel = np.abs(tr.transformed - want).max() / np.abs(want).max()
        need(rel <= 1e-10, f"gwas: transform off by {rel:.2e} (relative)")
        for fname, arr in (("pheno.phenotypes_and_permutations",
                            tr.phenotypes),
                           ("pheno.phenotypes_permuted_transformed",
                            tr.transformed)):
            head, accs, vals = read_table_tsv(os.path.join(out, fname))
            # written in %g: 6 significant digits
            need(head[1:] == tr.names and accs == names
                 and np.allclose(vals, arr, rtol=1e-5, atol=0),
                 f"gwas: {fname} differs from the transform's table")
        log(f"gwas {backend}: kinship equal to phase 8's bit for bit; "
            f"transform within {rel:.2e} of the numpy Cholesky solve "
            f"(vg {tr.vg:.6g}, ve {tr.ve:.6g}); written tables within "
            f"%g's 6 digits")
        # thresholds: the order statistic of kmers/best_pvals
        best = {}
        for ln in open(os.path.join(out, "kmers", "best_pvals")):
            name, v = ln.split("\t")
            best[name] = float(v)
        perm = sorted((best[f"P{i}"] for i in range(1, n_perm + 1)),
                      reverse=True)
        for key, q in (("5per", 0.05), ("10per", 0.10)):
            th = perm[int(n_perm * q) - 1]
            need(th == res.thresholds[key], f"gwas: threshold {key}")
            need(open(os.path.join(out, "kmers", f"threshold_{key}")).read()
                 == f"{th:f}\n", f"gwas: threshold_{key} file")
        need(best["phenotype_value"] == -math.log10(max(p[0].min(), 1e-300)),
             "gwas: best_pvals of phenotype_value")
        # pass files: every k-mer of phenotype_value's assoc table over the
        # threshold, in its order, with its p-value
        rs, af, l_mle, p_file = read_assoc(os.path.join(
            out, "kmers", "output", "phenotype_value.assoc.txt.gz"))
        need(len(rs) == k and np.allclose(p_file, p[0], rtol=5e-6, atol=0),
             "gwas: phenotype_value.assoc.txt.gz differs from the LMM")
        for key in ("5per", "10per"):
            th = res.thresholds[key]
            want_lines = [f"{r.rsplit('_', 1)[0]}\t{pv:.6e}\n"
                          for r, pv in zip(rs, p[0])
                          if -math.log10(max(pv, 1e-300)) > th]
            got = open(os.path.join(out, "kmers",
                                    f"pass_threshold_{key}")).readlines()
            need(got == want_lines, f"gwas: pass_threshold_{key} differs "
                 f"({len(got)} lines, {len(want_lines)} expected)")
        log(f"gwas {backend}: thresholds equal the order statistic of "
            f"best_pvals; the pass files follow the assoc table")
    a, b = runs["device32"], runs["host64"]
    for j in range(1 + n_perm):
        need(np.array_equal(a["sr"].rows[j], b["sr"].rows[j]),
             f"gwas: the two runs' candidates differ in column {j}")
    need(np.array_equal(a["tr"].transformed, b["tr"].transformed),
         "gwas: the two runs' transforms differ")
    # the scan's top-k: the f64 oracle's, as phase 3 holds it
    t0 = time.perf_counter()
    sr, tr = b["sr"], b["tr"]
    need(sr.certified is not None and all(sr.certified),
         f"gwas: certified {sum(sr.certified or [])} columns")
    cols = (0, n_perm // 2, n_perm)
    # the scan scores the float32-cast phenotypes (certify re-scores them
    # in f64), as phase 3's oracle does
    oracle = oracle_top(base, n, tr.transformed[:, cols].astype(np.float32),
                        main["keep"], k, device=device)
    for j, (bv, br) in zip(cols, oracle):
        need(np.array_equal(sr.rows[j], br),
             f"gwas: column {j}: rows differ from the f64 oracle")
        need(np.allclose(sr.scores[j], bv, rtol=1e-12, atol=0),
             f"gwas: column {j}: scores differ from the f64 oracle")
    log(f"gwas: columns {list(cols)}: top-{k} rows equal the f64 oracle's "
        f"({time.perf_counter() - t0:.1f} s)")
    # host64 against a scipy oracle, 3 columns x 32 candidates
    t0 = time.perf_counter()
    K = np.loadtxt(os.path.join(b["out"], "pheno.kinship"), delimiter="\t")
    d, U = np.linalg.eigh(K)
    rng = np.random.default_rng(18)
    worst = 0.0
    for j in cols:
        idx = np.concatenate([[0], rng.choice(np.arange(1, k), 31,
                                              replace=False)])
        pa = np.asarray(sr.pa_rows.take(sr.rows[j][idx]))
        x = np.unpackbits(np.ascontiguousarray(pa).view(np.uint8), axis=1,
                          bitorder="little")[:, :n].astype(np.float64)
        yj = tr.phenotypes[:, j] - tr.phenotypes[:, j].mean()
        want = np.array([ml_lrt_oracle(xi, yj, d, U) for xi in x])
        got = b["p"][j, idx]
        err = np.abs(got - want) / want
        worst = max(worst, float(err.max()))
        need(bool((err <= 1e-4).all()),
             f"gwas: column {j}: host64 p-values off the scipy oracle by "
             f"up to {err.max():.2e} (relative)")
    log(f"gwas: host64 p-values of 3 x 32 candidates within {worst:.2e} "
        f"(relative; tolerance 1e-4) of the scipy oracle "
        f"({time.perf_counter() - t0:.1f} s)")
    # device32 against host64: log10 p within 5e-2 where p < 0.05 (the JAX
    # package's test); elsewhere p within 2e-3 or the LRT within 5e-3, the
    # float32 resolution of the LRT at n=1008 (near p = 1, p =
    # erfc(sqrt(LRT / 2)) turns an LRT error e into a p error ~sqrt(e))
    from scipy.stats import chi2
    p32, p64 = a["p"], b["p"]
    small = p64 < 0.05
    dlog = np.abs(np.log10(p32[small]) - np.log10(p64[small]))
    dp = np.abs(p32 - p64)
    dlrt = np.abs(chi2.isf(p32, 1) - chi2.isf(p64, 1))
    over = dp > 2e-3
    log(f"gwas: device32 against host64 over {p64.size} tests: max |dp| "
        f"{dp.max():.2e} ({int(over.sum())} over 2e-3), max |dLRT| "
        f"{dlrt.max():.2e}, max |dlog10 p| "
        f"{dlog.max() if small.any() else 0:.2e} "
        f"over the {int(small.sum())} with p < 0.05")
    need(not small.any() or dlog.max() <= 5e-2,
         f"gwas: device32 log10 p off by {dlog.max():.2e}")
    bad = over & (dlrt > 5e-3)
    need(not bad.any(), f"gwas: device32 off host64 in {int(bad.sum())} "
         f"tests by |dp| over 2e-3 and |dLRT| over 5e-3")
    log(f"gwas: phase wall {time.perf_counter() - t_phase:.1f} s")
    return dict(k1=launches[0], k2=launches[1], k7=launches[2],
                k7t=launches[3])


def phase_gwas_cli(workdir, devices=("cuda", "cpu"), n=200, n_perm=10):
    """`gwas --device cuda` against `--device cpu` on phase 5's table
    (N=200, 20,000 rows): 10 permutations, -k 100, --score_precision
    highest, --certify_topk (the candidates ranked by f64 re-scores, so
    float32 near-ties cannot swap ranks between the devices). Every
    artifact byte-identical, except those holding full floats or times
    (summary.json, best_pvals, assoc.txt.gz, the pass files' p-values and
    log_file): parsed and compared at rtol 1e-9."""
    base = os.path.join(workdir, "small")
    names = [ln.strip() for ln in open(base + ".names")]
    need(len(names) == n, "gwas cli: phase 5's table is missing")
    pheno = os.path.join(workdir, "gwas_small.pheno")
    write_gwas_phenotype(pheno, names, seed=19)
    outs = []
    for i, dev in enumerate(devices):
        if os.path.exists(base + ".kinship"):
            os.remove(base + ".kinship")     # each run computes kinship
        out = os.path.join(workdir, f"gwas_cli_{i}_{dev}")
        cmd = [sys.executable, "-m", "kmersgwas_tpu_torch.cli", "gwas",
               "--pheno", pheno, "--kmers_table", base, "--outdir", out,
               "-l", "31", "-k", "100", "--permutations", str(n_perm),
               "--batch_size", "4096", "--score_precision", "highest",
               "--certify_topk", "--device", dev]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        need(proc.returncode == 0,
             f"gwas --device {dev} failed:\n{proc.stdout}\n{proc.stderr}")
        log(f"gwas --device {dev}: {proc.stdout.strip()} "
            f"({time.perf_counter() - t0:.1f} s)")
        outs.append(gwas_outputs(out))
    n_same, n_diff = compare_gwas_outputs(*outs)
    log(f"gwas cli: {n_same} files byte-identical between --device "
        f"{devices[0]} and --device {devices[1]}; assoc.txt.gz, best_pvals, "
        f"the pass files and summary.json within rtol 1e-9 ({n_diff} lines "
        f"differ in bytes)")


def gwas_outputs(out):
    """{path relative to out: bytes} of every file a gwas run wrote."""
    files = {}
    for root, _, fs in os.walk(out):
        for f in fs:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, out)] = fh.read()
    return files


# the gwas artifacts that hold full floats or times: parsed, not compared
# byte for byte
GWAS_PARSED = ("summary.json", "log_file", "kmers/best_pvals",
               "kmers/pass_threshold_5per", "kmers/pass_threshold_10per",
               "kmers/output/phenotype_value.assoc.txt.gz",
               "snps/best_pvals", "snps/pass_threshold_5per",
               "snps/pass_threshold_10per")
# the exact LMM's (l_mle, p_lrt) across devices where a float64 kinship's
# rounding differs (the SNP kinship): lambda's profile is flat to its
# rounding near the optimum, where the golden-section search follows the
# noise (ROADMAP section C, known item 4; 2.3e-4 = ln(10) x 1e-4 in log10
# lambda, as tests/test_torch_stats.py holds it)
LMM_RTOL = (2.3e-4, 1e-6)


def compare_gwas_outputs(a, b, rtol=1e-9, prefix="", lmm_rtol=None,
                         kinship_atol=None):
    """Two gwas runs' outputs (gwas_outputs; the run's files under
    `prefix`): the same files, every one byte-identical but GWAS_PARSED and
    the SNP arm's assoc tables (and pheno.kinship where kinship_atol is
    given); in those the same lines and fields, text fields equal, numbers
    within rtol, the assoc layout's l_mle and p_lrt within lmm_rtol where
    given, pheno.kinship within kinship_atol (summary.json's keys equal,
    stage_seconds and log_file not compared) -> (files byte-identical,
    lines of the parsed tables that differ in bytes)."""
    import gzip
    need(sorted(a) == sorted(b),
         f"gwas: files differ: {sorted(a)} vs {sorted(b)}")

    def rel(f):
        return f[len(prefix):] if f.startswith(prefix) else None
    parsed = [f for f in a if rel(f) is not None and (
        rel(f) in GWAS_PARSED or rel(f).startswith("snps/output/")
        or (kinship_atol is not None and rel(f) == "pheno.kinship"))]
    diff = [f for f in a if f not in parsed and a[f] != b[f]]
    need(not diff, f"gwas: outputs differ: {diff}")
    need(any(f.endswith(".bed") for f in a), "gwas: no bed output")
    n_diff = 0
    for f in parsed:
        if rel(f) in ("summary.json", "log_file"):
            continue
        la, lb = ((gzip.decompress(x[f]) if f.endswith(".gz") else x[f])
                  .decode().splitlines() for x in (a, b))
        need(len(la) == len(lb), f"gwas: {f}: line counts differ")
        for x, z in zip(la, lb):
            n_diff += x != z
            ta, tb = x.split("\t"), z.split("\t")
            need(len(ta) == len(tb), f"gwas: {f}: fields differ")
            for i, (u, v) in enumerate(zip(ta, tb)):
                try:
                    fu, fv = float(u), float(v)
                except ValueError:      # k-mer, name and rank fields
                    need(u == v, f"gwas: {f}: {u!r} != {v!r}")
                    continue
                if rel(f) == "pheno.kinship":
                    ok = abs(fu - fv) <= kinship_atol
                elif lmm_rtol is not None and len(ta) == 9 and i >= 7:
                    ok = math.isclose(fu, fv, rel_tol=lmm_rtol[i - 7])
                else:
                    ok = math.isclose(fu, fv, rel_tol=rtol, abs_tol=0.0)
                need(ok, f"gwas: {f}: {u} != {v}")
    if prefix + "summary.json" in a:
        sa, sb = (json.loads(x[prefix + "summary.json"]) for x in (a, b))
        need(sorted(sa) == sorted(sb), "gwas: summary.json keys differ")
        for key in sa:
            va, vb = sa[key], sb[key]
            need(key == "stage_seconds" or va == vb
                 or (isinstance(va, float) and isinstance(vb, float)
                     and math.isclose(va, vb, rel_tol=rtol)),
                 f"gwas: summary.json {key}: {va} != {vb}")
    return sum(f not in parsed for f in a), n_diff


# ---------------------------------------------------------------- phase 19

SNP_M = 1 << 20            # SNPs of phase 19's bed
SNP_CHUNK = 1 << 16        # SNPs made a chunk
SNP_SMALL = 1 << 14        # phase 19 (d)'s depth cut


def write_snp_bed(base, names, m, seed, causal=None, device="cuda"):
    """Synthetic PLINK bed/bim/fam made on `device` from a seed, a chunk
    of SNPs at a time: per SNP a minor allele frequency uniform in [0.01,
    0.5]; per call missing with probability 0.05, else heterozygous with
    0.02, else homozygous for the minor allele with the SNP's frequency.
    causal = (index, 0/1 per sample) plants one SNP with no missing or het
    call (hom alt where 1). len(names) must be a multiple of 4."""
    import torch
    from kmersgwas_tpu_torch.core import formats
    n = len(names)
    need(n % 4 == 0, "write_snp_bed: samples not a multiple of 4")
    gen = torch.Generator(device=device).manual_seed(seed)
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=device)
    with open(base + ".bed", "wb") as f:
        f.write(formats.PLINK_BED_MAGIC)
        for s in range(0, m, SNP_CHUNK):
            c = min(SNP_CHUNK, m - s)
            maf = 0.01 + 0.49 * torch.rand((c, 1), generator=gen,
                                           device=device)
            r = torch.rand((c, n), generator=gen, device=device)
            alt = torch.rand((c, n), generator=gen, device=device) < maf
            d = torch.where(r < 0.05, 1, torch.where(
                r < 0.07, 2, torch.where(alt, 3, 0))).to(torch.uint8)
            if causal is not None and s <= causal[0] < s + c:
                d[causal[0] - s] = torch.as_tensor(
                    np.where(causal[1], 3, 0), dtype=torch.uint8,
                    device=device)
            by = (d.view(c, n // 4, 4) << shifts).sum(-1).to(torch.uint8)
            f.write(by.cpu().numpy().tobytes())
    with open(base + ".bim", "w") as f:
        f.write("".join(f"{1 + i * 22 // m}\tsnp{i}\t0\t{1000 + 37 * i}"
                        f"\tA\tG\n" for i in range(m)))
    formats.write_fam(base + ".fam", names, np.zeros(n))


def bed_body(base, n):
    """The bed's genotype bytes, (M, n/4) uint8, mapped."""
    return np.memmap(base + ".bed", dtype=np.uint8, mode="r", offset=3) \
        .reshape(-1, n // 4)


def bed_columns(body, cols):
    """(M, len(cols)) dubits of the samples `cols`, by numpy."""
    cols = np.asarray(cols)
    return (body[:, cols // 4] >> (2 * (cols % 4)).astype(np.uint8)) & 3


def kinship_pairs_oracle(body, n, pairs, device, chunk=1 << 16):
    """float64 EMMA kinship (emma_kinship.cpp:67-152: the two imputed
    passes, straight from the formula) of the sample pairs, over chunks of
    the bed's bytes decoded with plain torch on `device` (none of the
    port's code)."""
    import torch
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8, device=device)
    pi, pj = (torch.as_tensor(pairs[:, c], device=device) for c in (0, 1))
    acc = torch.zeros(len(pairs), dtype=torch.float64, device=device)
    used = 0
    for s in range(0, body.shape[0], chunk):
        b = torch.from_numpy(np.asarray(body[s:s + chunk])).to(device)
        d = ((b[..., None] >> shifts) & 3).reshape(b.shape[0], -1)[:, :n]
        hom = (d == 3).sum(1, keepdim=True).double()
        het = (d == 2).sum(1, keepdim=True).double()
        obs = (d != 1).sum(1, keepdim=True).double()
        keep = obs[:, 0] > 0
        used += int(keep.sum())
        for maf, val in ((hom / obs, d == 3), ((hom + het) / obs,
                                               (d == 3) | (d == 2))):
            g = torch.where(d == 1, maf, val.double())[keep]
            gi, gj = g[:, pi], g[:, pj]
            acc += (gi * gj + (1 - gi) * (1 - gj)).sum(0)
    return (acc / (2 * used)).cpu().numpy()


def snp_scores_oracle(body, rows, y, min_count):
    """numpy float64 GRAMMAR scores (snps_multiple_databases.cpp:157-172)
    of the SNPs `rows` against y (n, P), from the bed's bytes."""
    n = y.shape[0]
    d = bed_columns(body[np.sort(rows)], np.arange(n))
    d = d[np.argsort(np.argsort(rows))]
    g = (d == 3) + 0.5 * (d == 2)
    obs = (d != 1).astype(float)
    N, S, S2 = obs.sum(1)[:, None], g.sum(1)[:, None], (g * g).sum(1)[:, None]
    r = N * (g @ y) - S * (obs @ y)
    denom = N * (N * S2 - S * S)
    sc = np.where(denom > 0, r * r / np.where(denom > 0, denom, 1), 0.0)
    return np.where((S >= min_count) & (N - S >= min_count), sc, 0.0)


def snp_scores_f64(planes, y, min_count, block=1 << 16):
    """Every SNP's GRAMMAR score in float64 on the planes' device (plain
    torch: unpacked planes, float64 products) -> (M, P)."""
    import torch
    yy = torch.zeros((planes.n_pad, y.shape[1]), dtype=torch.float64,
                     device=planes.presence.device)
    yy[:planes.n_samples] = torch.from_numpy(y.astype(np.float64))
    shifts = torch.arange(32, dtype=torch.int32, device=yy.device)
    out = []
    for s in range(0, planes.presence.shape[0], block):
        def bits(p):
            return ((p[s:s + block, :, None] >> shifts) & 1).reshape(
                p[s:s + block].shape[0], -1).to(torch.float64)
        g = bits(planes.presence) + 0.5 * bits(planes.het)
        ob = bits(planes.nonmiss)
        N, S = ob.sum(1, keepdim=True), g.sum(1, keepdim=True)
        S2 = (g * g).sum(1, keepdim=True)
        r = N * (g @ yy) - S * (ob @ yy)
        denom = N * (N * S2 - S * S)
        sc = torch.where(denom > 0, r * r / denom, 0.0)
        out.append(torch.where((S >= min_count) & (N - S >= min_count), sc,
                               0.0))
    return torch.cat(out)


def count_boundary_swaps(idx, s64, k, rtol=1e-5):
    """Each column's selected rows idx[j] against the float64 ranking's
    top k of s64 (M, P) on the device (a stable descending sort: the lower
    index first on ties) -> the number of selected rows outside the
    float64 set, per column; fails unless each of them, and each float64
    row left out, lies within rtol of the column's k-th float64 score (a
    swap within float32 rounding at the boundary)."""
    import torch
    top = torch.sort(s64.T, dim=1, descending=True,
                     stable=True).indices[:, :k]
    kth = s64.T.gather(1, top[:, k - 1:]).cpu().numpy()[:, 0]
    top = top.cpu().numpy()
    s64 = s64.cpu().numpy()
    swaps = []
    for j, got in enumerate(idx):
        odd = np.setxor1d(got, top[j])
        bad = np.abs(s64[odd, j] - kth[j]) > rtol * abs(kth[j])
        need(len(got) == k and not bad.any(),
             f"snps: column {j}: {int(bad.sum())} selected rows off the "
             f"float64 ranking beyond float32 rounding")
        swaps.append(len(np.setdiff1d(got, top[j])))
    return swaps


def status_kb(key):
    with open("/proc/self/status") as f:
        for ln in f:
            if ln.startswith(key + ":"):
                return int(ln.split()[1])
    raise PhaseError(f"/proc/self/status has no {key}")


def max_rss_kb():
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss


class PeakRSS:
    """The peak host RSS increase over a `with` block, in bytes: the
    largest VmRSS a sampling thread reads (every 10 ms) or, where the block
    sets the process's new high-water mark, that mark itself (exact;
    getrusage's ru_maxrss), less VmRSS at the start. The card's machine
    can neither reset the mark (/proc/self/clear_refs) nor show VmHWM."""

    def __enter__(self):
        import threading
        self.start, self.hwm0 = status_kb("VmRSS"), max_rss_kb()
        self.peak, self.stop = self.start, threading.Event()

        def sample():
            while not self.stop.wait(0.01):
                self.peak = max(self.peak, status_kb("VmRSS"))
        self.thread = threading.Thread(target=sample, daemon=True)
        self.thread.start()
        return self

    def __exit__(self, *exc):
        self.stop.set()
        self.thread.join()
        hwm = max_rss_kb()
        peak = max(self.peak, status_kb("VmRSS"),
                   hwm if hwm > self.hwm0 else 0)
        self.increase = (peak - self.start) * 1024


class Measured:
    """Wraps `module.name` for one run: each call's wall, its peak host
    RSS increase (PeakRSS) and the peak device memory it allocated, kept
    in call order with its result."""

    def __init__(self, module, name, device):
        self.module, self.name, self.device, self.calls = \
            module, name, device, []

    def __enter__(self):
        import torch
        fn = self.orig = getattr(self.module, self.name)
        cuda = self.device == "cuda"

        def wrapper(*a, **k):
            if cuda:
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats()
                dev0 = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            with PeakRSS() as rss:
                r = fn(*a, **k)
                if cuda:
                    torch.cuda.synchronize()
            self.calls.append(dict(
                result=r, wall=time.perf_counter() - t0, rss=rss.increase,
                device=torch.cuda.max_memory_allocated() - dev0 if cuda
                else 0))
            return r
        setattr(self.module, self.name, wrapper)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def read_assoc_rows(path):
    """assoc.txt -> (SNP indices from the rs names snp<i>, af, l_mle,
    p_lrt)."""
    rs, af, l_mle, p = read_assoc(path)
    return np.array([int(r[3:]) for r in rs]), af, l_mle, p


def snp_dose(body, i, cols):
    """SNP i's mean-imputed dose over the samples `cols` (in that order),
    as GEMMA's -miss handling: missing calls at the observed mean."""
    d = bed_columns(body[i:i + 1], np.asarray(cols))[0]
    g = (d == 3) + 0.5 * (d == 2)
    obs = d != 1
    return np.where(obs, g, g[obs].sum() / max(obs.sum(), 1))


def phase_snps(main, workdir, m=SNP_M, n_snps=10001, n_perm=100, k=10001,
               batch=2_000_000, device="cuda"):
    """The SNP arm at a real size: a synthetic bed of SNP_M = 2^20 SNPs
    over phase 3's 1008 accessions in the table's order (write_snp_bed,
    one planted causal SNP).
    (a) emma_kinship_from_bed on the card against a float64
        recomputation from the formula on 64 sampled pairs (plain torch
        on the bed's bytes; atol 1e-12);
    (b) most_associated_snps over 1 + 100 columns, top-10001: the scores
        of 4096 sampled SNPs against numpy float64 from the bed's bytes,
        each column's set against the float64 ranking's (swaps only within
        float32 rounding at the boundary, counted);
    (c) run_gwas on phase 3's table and this bed, kinship_snps, two_steps,
        100 permutations, top-10001, 2M-row batches: the planted SNP
        passes the 5 % threshold, p-values of 32 SNPs of the real column
        and of 3 permutation columns against the scipy oracle (as phase
        18), the thresholds the order statistic of best_pvals, K1 and K2
        launched and K7 not; stage seconds, the SNP arm's peak host RSS
        increase (under 1.5 GB) and peak device memory;
    (d) one_step on the first SNP_SMALL = 2^14 SNPs x 101 columns (a depth
        cut: 101 x 2^20 exact tests would set the smoke's wall), its real
        column equal to (c)'s on those SNPs;
    (e) the CLI on a 20,000-SNP x 200-sample bed over phase 5's table:
        kinship-bed, associate-snps and gwas --run_on_snps_two_steps
        --kinship_snps (10 permutations), --device cuda against --device
        cpu (compare_gwas_outputs).
    Smaller arguments and device="cpu" rehearse the phase without a
    card."""
    import torch
    from kmersgwas_tpu_torch.ops import kinship as kin_ops
    from kmersgwas_tpu_torch.ops import score
    from kmersgwas_tpu_torch.pipeline import gwas as gwas_mod
    from kmersgwas_tpu_torch.pipeline import kinship as km
    from kmersgwas_tpu_torch.snps import assoc
    from kmersgwas_tpu_torch.snps import bed as bed_mod
    cuda = device == "cuda"
    names, n = main["names"], main["n"]
    causal_i = m * 3 // 4 + 1
    bed = os.path.join(workdir, "snps")
    rng = np.random.default_rng(19)
    causal = rng.random(n) < 0.5
    t_phase = t0 = time.perf_counter()
    write_snp_bed(bed, names, m, seed=19, causal=(causal_i, causal),
                  device=device)
    body = bed_body(bed, n)
    log(f"snps: bed of {m} SNPs x {n} samples written in "
        f"{time.perf_counter() - t0:.1f} s ({os.path.getsize(bed + '.bed')}"
        f" bytes)")

    # (a) SNP kinship
    from kmersgwas_tpu_torch.snps import kinship as snp_kin
    with Measured(snp_kin, "emma_kinship_from_bed", device) as mk:
        K = snp_kin.emma_kinship_from_bed(bed, device=device)
    pairs = rng.choice(n, size=(96, 2))
    pairs = pairs[pairs[:, 0] != pairs[:, 1]][:64]
    t0 = time.perf_counter()
    want = kinship_pairs_oracle(body, n, pairs, device)
    err = np.abs(K[pairs[:, 0], pairs[:, 1]] - want).max()
    need(err <= 1e-12, f"snps: kinship off the numpy oracle by {err:.2e}")
    need(np.array_equal(K, K.T) and np.all(np.diag(K) == 1.0),
         "snps: kinship not symmetric with a unit diagonal")
    log(f"snps (a): emma_kinship_from_bed {mk.calls[0]['wall']:.3f} s "
        f"({m / mk.calls[0]['wall']:,.0f} SNPs/s), host RSS +"
        f"{mk.calls[0]['rss'] / 2**20:.0f} MiB, device peak "
        f"{mk.calls[0]['device'] / 2**30:.2f} GiB; {len(pairs)} pairs "
        f"within {err:.2e} of a float64 recomputation "
        f"({time.perf_counter() - t0:.1f} s)")

    # (b) GRAMMAR prefilter: 1 + 100 columns
    y = np.random.default_rng(20).normal(size=(n, 1 + n_perm))
    y[:, 0] += 0.5 * (causal - causal.mean()) / causal.std()
    y = y.astype(np.float32)
    min_count = max(5.0, math.ceil(0.05 * n))
    t0 = time.perf_counter()
    planes = bed_mod.load_bed_planes(bed, names, device=device)
    if cuda:
        torch.cuda.synchronize()
    t_planes = time.perf_counter() - t0
    t0 = time.perf_counter()
    idx, scores = assoc.most_associated_snps(planes, y, n_snps, 0.05, 5)
    t_scores = time.perf_counter() - t0
    sample = np.sort(rng.choice(m, size=4096, replace=False))
    want = snp_scores_oracle(body, sample, y.astype(np.float64), min_count)
    got = scores[torch.as_tensor(sample, device=scores.device)].cpu() \
        .numpy()
    tol = 1e-5 * np.abs(want) + 1e-5 * np.abs(want).max(0)
    need(bool((np.abs(got - want) <= tol).all()),
         f"snps: scores off numpy float64 by up to "
         f"{np.abs(got - want).max():.2e}")
    s64 = snp_scores_f64(planes, y, min_count)
    top = min(n_snps, m)
    swaps = count_boundary_swaps(idx, s64, top)
    need(causal_i in set(idx[0].tolist()), "snps: the causal SNP was not "
         "selected in the real column")
    log(f"snps (b): planes {t_planes:.3f} s, scores + top-{top} of "
        f"{y.shape[1]} columns {t_scores:.3f} s; 4096 sampled SNPs x "
        f"{y.shape[1]} columns within rtol 1e-5 (+1e-5 of the column's "
        f"largest) of numpy float64, max |d| "
        f"{np.abs(got - want).max():.2e}; {sum(swaps)} boundary swaps "
        f"against the float64 ranking over {y.shape[1]} columns (max "
        f"{max(swaps)} in a column)")
    del planes, scores, s64

    # (c) run_gwas with the SNP arm two_steps on the SNP kinship
    pheno = os.path.join(workdir, "snps.pheno")
    write_phenotypes(pheno, ["phenotype_value"], names, y[:, :1])
    out = os.path.join(workdir, "gwas_snps")
    cfg = gwas_mod.GWASConfig(
        pheno_path=pheno, kmers_table=main["base"], outdir=out,
        kmer_len=main["kmer_len"], n_kmers=k, n_permutations=n_perm,
        batch_size=batch, dtable_cache=main["dtable"], device=device,
        snps_matrix=bed, run_snps="two_steps", kinship_snps=True,
        n_snps=n_snps)
    counters = (score.score_batch_t_topw, score.score_batch_t_bmax,
                kin_ops.kinship_accumulate)
    for c in counters:
        c.launches = 0
    with Capture(gwas_mod.transform_mod, "transform_and_permute") as ctr, \
            Measured(gwas_mod.snp_gwas, "run_snp_arm", device) as arm, \
            Measured(gwas_mod.snp_kinship, "emma_kinship_from_bed",
                     device) as kin_c:
        t0 = time.perf_counter()
        res = gwas_mod.run_gwas(cfg)
        wall = time.perf_counter() - t0
    launches = [c.launches for c in counters]
    tr = ctr.calls[0]
    summ = arm.calls[0]
    st = summ["result"]["stage_seconds"]
    n_tests = summ["result"]["n_tests"]
    log(f"snps (c): run_gwas wall {wall:.2f} s; stage_seconds "
        + json.dumps({a: round(b, 3) for a, b in res.stage_seconds.items()}))
    log(f"snps (c): SNP kinship {kin_c.calls[0]['wall']:.3f} s, SNP planes "
        f"{st['snps.planes']:.3f} s, SNP scores {st['snps.scores']:.3f} s, "
        f"SNP LMM {st['snps.lmm']:.3f} s ({n_tests} tests, "
        f"{n_tests / st['snps.lmm']:,.0f} tests/s), SNP artifacts "
        f"{st['snps.artifacts']:.3f} s; the SNP arm {summ['wall']:.2f} s, "
        f"peak host RSS increase {summ['rss'] / 2**20:.0f} MiB (SNP "
        f"kinship {kin_c.calls[0]['rss'] / 2**20:.0f} MiB), peak device "
        f"memory {summ['device'] / 2**30:.2f} GiB")
    log(f"snps (c): K1 {launches[0]}, K2 {launches[1]}, K7 {launches[2]} "
        f"launches; thresholds {res.thresholds}")
    need(max(summ["rss"], kin_c.calls[0]["rss"]) < 1.5e9,
         "snps: the SNP arm's host RSS grew by 1.5 GB or more")
    need(not cuda or (launches[0] > 0 and launches[1] > 0),
         f"snps: K1 or K2 not launched: {launches}")
    need(launches[2] == 0, "snps: K7 ran with kinship_snps")
    K_run = np.loadtxt(os.path.join(out, "pheno.kinship"), delimiter="\t")
    need(np.array_equal(K_run, K), "snps: run_gwas's SNP kinship differs "
         "from (a)'s")
    sdir = os.path.join(out, "snps")
    best = {}
    for ln in open(os.path.join(sdir, "best_pvals")):
        name, v = ln.split("\t")
        best[name] = float(v)
    perm = sorted((best[f"P{i}"] for i in range(1, n_perm + 1)),
                  reverse=True)
    for key, q in (("5per", 0.05), ("10per", 0.10)):
        th = perm[int(n_perm * q) - 1]
        need(open(os.path.join(sdir, f"threshold_{key}")).read()
             == f"{th:f}\n", f"snps: threshold_{key}")
    passed = [ln.split("\t")[1] for ln in
              open(os.path.join(sdir, "pass_threshold_5per"))]
    need(f"snp{causal_i}" in passed, "snps: the planted SNP does not pass "
         "the 5 % threshold")
    # p-values against the scipy oracle: the real column and 3 permutation
    # columns, 32 SNPs each (the planted one in the real column)
    t0 = time.perf_counter()
    d_eig, U_eig = np.linalg.eigh(K_run)
    worst = 0.0
    for j in (0, 1, n_perm // 2, n_perm):
        cname = tr.names[j]
        rows, _, _, p_file = read_assoc_rows(
            os.path.join(sdir, "output", f"{cname}.assoc.txt"))
        pick = rng.choice(len(rows), size=32, replace=False)
        if j == 0:
            pick[0] = int(np.nonzero(rows == causal_i)[0][0])
        yj = tr.phenotypes[:, j] - tr.phenotypes[:, j].mean()
        want = np.array([ml_lrt_oracle(snp_dose(body, rows[i], np.arange(n)),
                                       yj, d_eig, U_eig) for i in pick])
        err = np.abs(p_file[pick] - want) / want
        worst = max(worst, float(err.max()))
        need(bool((err <= 1e-4).all()), f"snps: column {cname}: p-values "
             f"off the scipy oracle by up to {err.max():.2e} (relative)")
    log(f"snps (c): planted snp{causal_i} passes the 5 % threshold "
        f"({len(passed)} pass); 4 x 32 p-values within {worst:.2e} "
        f"(relative; tolerance 1e-4, printed at 7 digits) of the scipy "
        f"oracle ({time.perf_counter() - t0:.1f} s); the thresholds equal "
        f"the order statistic of best_pvals")

    # (d) one_step on the first SNP_SMALL SNPs, every column
    small = os.path.join(workdir, "snps_small")
    ms = min(SNP_SMALL, m)
    with open(small + ".bed", "wb") as f:
        f.write(open(bed + ".bed", "rb").read(3 + ms * (n // 4)))
    with open(bed + ".bim") as src, open(small + ".bim", "w") as f:
        for _, ln in zip(range(ms), src):
            f.write(ln)
    shutil.copy(bed + ".fam", small + ".fam")
    out_d = os.path.join(workdir, "snps_one_step")
    t0 = time.perf_counter()
    r_d = gwas_mod.snp_gwas.run_snp_arm(
        small, out_d, names, tr.phenotypes, tr.transformed, tr.names, d_eig,
        U_eig, mode="one_step", n_snps=n_snps, maf=0.05, mac=5,
        n_permutations=n_perm, device=device)
    wall_d = time.perf_counter() - t0
    rows_c, _, _, p_c = read_assoc_rows(
        os.path.join(sdir, "output", "phenotype_value.assoc.txt"))
    rows_d, _, _, p_d = read_assoc_rows(
        os.path.join(out_d, "snps", "output", "phenotype_value.assoc.txt"))
    head = rows_c < ms
    need(np.array_equal(rows_d, rows_c[head]), "snps (d): the real column's "
         "SNPs differ from (c)'s")
    need(np.allclose(p_d, p_c[head], rtol=1e-5, atol=0),
         "snps (d): real-column p-values differ from (c)'s")
    for cname in tr.names:
        rows_j, _, _, p_j = read_assoc_rows(
            os.path.join(out_d, "snps", "output", f"{cname}.assoc.txt"))
        need(np.array_equal(rows_j, rows_d) and np.isfinite(p_j).all(),
             f"snps (d): column {cname}")
    st_d = r_d["stage_seconds"]
    log(f"snps (d): one_step on {ms} SNPs x {len(tr.names)} columns: "
        f"{r_d['n_tests']} tests, LMM {st_d['snps.lmm']:.3f} s "
        f"({r_d['n_tests'] / st_d['snps.lmm']:,.0f} tests/s), artifacts "
        f"{st_d['snps.artifacts']:.3f} s, wall {wall_d:.2f} s; the real "
        f"column equal to (c)'s")
    del body
    phase_snps_cli(workdir, devices=(device, "cpu"))
    log(f"snps: phase wall {time.perf_counter() - t_phase:.1f} s")
    return dict(k1=launches[0], k2=launches[1])


def phase_snps_cli(workdir, devices=("cuda", "cpu"), m=20_000, n_perm=10):
    """Phase 19 (e): kinship-bed, associate-snps (dyadic phenotypes, so
    the float32 scores and their top-N are the same on both devices) and
    gwas --snp_matrix --run_on_snps_two_steps --kinship_snps on phase 5's
    table (N=200), --device cuda against --device cpu: stdout and files
    byte-identical, but those holding full floats, times or the exact
    LMM's l_mle and p_lrt (compare_gwas_outputs). The commands run through
    the CLI's entry point in this process (phases 5, 9 and 18 start the
    CLI as a new process; each start costs ~9 s on the card)."""
    import contextlib
    import io
    from kmersgwas_tpu_torch.cli.__main__ import main as cli_main
    table = os.path.join(workdir, "small")
    names = [ln.strip() for ln in open(table + ".names")]
    need(len(names) == 200, "snps cli: phase 5's table is missing")
    bed = os.path.join(workdir, "snps_cli")
    write_snp_bed(bed, names, m, seed=21,
                  device="cuda" if devices[0] == "cuda" else "cpu")
    pheno_t = os.path.join(workdir, "snps_cli_t.pheno")
    write_phenotypes(pheno_t, ["phenotype_value"] + [f"P{i}" for i in
                                                       range(1, n_perm + 1)],
                     names, dyadic(np.random.default_rng(22),
                                   (len(names), 1 + n_perm)))
    pheno = os.path.join(workdir, "snps_cli.pheno")
    write_gwas_phenotype(pheno, names, seed=23)
    outs = []
    for i, dev in enumerate(devices):
        if os.path.exists(bed + ".kinship"):
            os.remove(bed + ".kinship")      # each run computes kinship
        out = os.path.join(workdir, f"snps_cli_{i}_{dev}")
        os.makedirs(out)
        runs = [("kinship-bed", [bed]),
                ("associate-snps", [pheno_t, bed, os.path.join(out, "sel"),
                                    "1000", "0.05", "5"]),
                ("gwas", ["--pheno", pheno, "--kmers_table", table,
                          "--outdir", os.path.join(out, "gwas"), "-l", "31",
                          "-k", "100", "--permutations", str(n_perm),
                          "--batch_size", "4096", "--score_precision",
                          "highest", "--certify_topk", "--snp_matrix", bed,
                          "--run_on_snps_two_steps", "--snps_number", "1000",
                          "--kinship_snps"])]
        for cmd, args in runs:
            t0 = time.perf_counter()
            stdout = io.StringIO()
            with contextlib.redirect_stdout(stdout):
                cli_main([cmd] + args + ["--device", dev])
            if cmd == "kinship-bed":
                with open(os.path.join(out, "kinship_bed.txt"), "w") as f:
                    f.write(stdout.getvalue())
            log(f"snps cli: {cmd} --device {dev} "
                f"({time.perf_counter() - t0:.1f} s)")
        outs.append(gwas_outputs(out))
    n_same, n_diff = compare_gwas_outputs(*outs, prefix="gwas/",
                                          lmm_rtol=LMM_RTOL,
                                          kinship_atol=1e-12)
    need("kinship_bed.txt" in outs[0] and "sel.P10.bed" in outs[0],
         "snps cli: outputs missing")
    log(f"snps cli: {n_same} files byte-identical between --device "
        f"{devices[0]} and --device {devices[1]} (kinship-bed's stdout, "
        f"associate-snps' bed/bim); the parsed ones within their "
        f"tolerances ({n_diff} lines differ in bytes)")


# ---------------------------------------------------------------- phase 20

def emma_inputs(K, m, g, seed):
    """(ys (g, n), xs (m, n)) for phase 20: doses 0 / 0.5 / 1 at a minor
    allele frequency uniform in [0.05, 0.5] per variant; NaNs in about 1 %
    of the xs entries: 20 samples missing in every other block of 256
    variants (a genotyping batch that lost them), and 1 to 4 missing in
    each of 32 variants of the complete blocks, each its own subset; and
    10 NaNs in the second ys row."""
    n = K.shape[0]
    rng = np.random.default_rng(seed)
    maf = rng.uniform(0.05, 0.5, size=(m, 1))
    u = rng.random((m, n))
    xs = np.where(u < maf * maf, 1.0, np.where(u < 2 * maf - maf * maf,
                                               0.5, 0.0))
    for b in range(0, m // 256, 2):
        xs[b * 256:(b + 1) * 256, rng.choice(n, 20, replace=False)] = np.nan
    singles = 256 + rng.choice(256, 32, replace=False)
    for i in singles:
        xs[i, rng.choice(n, 1 + i % 4, replace=False)] = np.nan
    ys = rng.normal(size=(g, n)) + 0.3 * (xs[0] > 0)
    ys[1, rng.choice(n, 10, replace=False)] = np.nan
    return ys, xs, singles


def phase_emma(main, kin, m=4096, g=2, n_cpu=128, device="cuda"):
    """The EMMA library on the card at n = 1008 (phase 8's kinship):
    emma_ML_LRT and emma_REML_t over m = 4096 variants and g = 2 rows
    (emma_inputs: NaNs in ~1 % of the xs entries and in one ys row), held
    to the port's own CPU float64 run on n_cpu sampled variants (8 of the
    single-subset ones, 64 from blocks with NaNs, the rest complete); then
    calc_gamma on phase 3's table, card against CPU."""
    import torch
    from kmersgwas_tpu_torch.stats import emma
    from kmersgwas_tpu_torch.stats.gamma import calc_gamma
    K = kin["K"]
    n = K.shape[0]
    ys, xs, singles = emma_inputs(K, m, g, seed=20)
    rng = np.random.default_rng(21)
    nan_rows = np.nonzero(np.isnan(xs).any(1))[0]
    # the CPU pays an eigendecomposition per subset: 8 single-subset
    # variants (every size), 64 of blocks 0 and 2, the rest complete
    clean = np.setdiff1d(np.arange(256, 512), singles)
    pick = np.sort(np.concatenate([
        singles[:8], rng.choice(256, 32, replace=False),
        512 + rng.choice(256, 32, replace=False),
        rng.choice(clean, n_cpu - 72, replace=False)]))
    log(f"emma: n={n}, m={m}, g={g}: {np.isnan(xs).mean() * 100:.3f} % of "
        f"the xs entries NaN, {len(nan_rows)} variants with NaNs, "
        f"{int(np.isnan(ys).sum())} NaNs in ys; the CPU run on {len(pick)} "
        f"variants ({int(np.isin(pick, nan_rows).sum())} with NaNs)")
    # rtol per field: vg and ve move with the root of a flat likelihood
    tols = {"vgs": 1e-6, "ves": 1e-6}
    for fn in (emma.emma_ML_LRT, emma.emma_REML_t):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = fn(ys, xs, K, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        t_dev = time.perf_counter() - t0
        t0 = time.perf_counter()
        want = fn(ys, xs[pick], K, device="cpu")
        t_cpu = time.perf_counter() - t0
        diffs = {}
        for key, w in want.items():
            a = got[key].cpu().numpy()[pick]
            w = w.numpy()
            need(a.shape == w.shape and np.array_equal(np.isnan(a),
                                                       np.isnan(w)),
                 f"emma {fn.__name__}: {key} shapes or NaNs differ")
            ok = ~np.isnan(w)
            rel = np.abs(a[ok] - w[ok]) / np.maximum(np.abs(w[ok]), 1e-300)
            diffs[key] = float(rel.max()) if rel.size else 0.0
            atol = 1e-8 if key == "stats" else 0.0
            need(np.allclose(a[ok], w[ok], rtol=tols.get(key, 1e-8),
                             atol=atol),
                 f"emma {fn.__name__}: {key} off the CPU run by up to "
                 f"{diffs[key]:.2e} (relative)")
        ps = got["ps"].cpu().numpy()
        need(ps.shape == (m, g) and bool(((ps >= 0) & (ps <= 1)).all()),
             f"emma {fn.__name__}: p-values out of [0, 1]")
        log(f"emma: {fn.__name__} on the card {t_dev:.2f} s "
            f"({m * g / t_dev:,.0f} tests/s), the CPU on {len(pick)} "
            f"variants {t_cpu:.2f} s; max relative differences "
            + json.dumps({k: float(f"{v:.3g}") for k, v in diffs.items()}))
    Vinv = np.linalg.inv(0.5 * K + 0.5 * np.eye(n))
    vals = {}
    for dev in (device, "cpu"):
        t0 = time.perf_counter()
        vals[dev] = calc_gamma(main["base"], Vinv, min_count=51,
                               names_to_use=main["names"], device=dev)
        log(f"emma: calc_gamma --device {dev} {vals[dev]!r} "
            f"({time.perf_counter() - t0:.2f} s)")
    need(math.isclose(vals[device], vals["cpu"], rel_tol=1e-5),
         "emma: calc_gamma differs between the card and the CPU")


# ---------------------------------------------------------------- phase 21

INGEST_ACCESSIONS = 241     # the reference's E. coli example (SURVEY.md)
INGEST_GENOME = 500_000     # bases: cut from E. coli's ~5 Mb to fit the smoke
INGEST_K = 31
INGEST_MAC = 5
INGEST_P = 0.2
INGEST_COVERAGE = 5
INGEST_READ = 100
INGEST_CASSETTE = 300
INGEST_TREE_MUTATIONS = 100  # mean substitutions per edge of the tree
INGEST_NUMPY = 8             # accessions also run on the numpy route
_FASTQ_TAIL = b"\n+\n"


def simulate_tree(rng, n):
    """A random binary tree over n leaves (random joins of two lineages)
    -> parent of each node (-1 at the root), leaves 0..n-1."""
    parent = np.full(2 * n - 1, -1, np.int64)
    active = list(range(n))
    nxt = n
    while len(active) > 1:
        i, j = sorted(rng.choice(len(active), 2, replace=False))
        parent[active[i]] = parent[active[j]] = nxt
        active[i] = nxt
        active.pop(j)
        nxt += 1
    return parent


def write_fastq(path, genome, rng, coverage, read_len):
    """coverage x len(genome) / read_len reads at uniform starts, half of
    them reverse-complemented, as FASTQ (quality 'I')."""
    n_reads = coverage * len(genome) // read_len
    starts = rng.integers(0, len(genome) - read_len + 1, size=n_reads)
    seq = genome[starts[:, None] + np.arange(read_len)]
    rc = rng.random(n_reads) < 0.5
    seq[rc] = 3 - seq[rc][:, ::-1]
    rec = np.empty((n_reads, 3 + read_len + 3 + read_len + 1), np.uint8)
    rec[:, :3] = np.frombuffer(b"@r\n", np.uint8)
    rec[:, 3:3 + read_len] = np.frombuffer(b"ACGT", np.uint8)[seq]
    rec[:, 3 + read_len:6 + read_len] = np.frombuffer(_FASTQ_TAIL, np.uint8)
    rec[:, 6 + read_len:-1] = ord("I")
    rec[:, -1] = ord("\n")
    rec.tofile(path)
    return n_reads


def cli_run(argv):
    """The port's CLI `main(argv)` in this process -> (stdout, stderr)."""
    import contextlib
    import io
    from kmersgwas_tpu_torch.cli.__main__ import main as cli
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        cli(argv)
    return out.getvalue(), err.getvalue()


def canonical_kmers(codes_u8, k):
    """Canonical k-mer codes of a 2-bit code sequence (no invalid bases)."""
    from kmersgwas_tpu_torch.core import codec
    from kmersgwas_tpu_torch.ingest import counter
    seq = np.frombuffer(b"ACGT", np.uint8)[codes_u8].tobytes()
    return np.unique(codec.canonize(counter.kmers_of_sequence(seq, k), k))


def encode_kmer_strings(strs):
    """Codes of equal-length ACGT strings, vectorized (the bim's k-mers)."""
    if not strs:
        return np.empty(0, np.uint64)
    u = np.array(strs, dtype="S").view(np.uint8).reshape(len(strs), -1)
    lut = np.zeros(256, np.uint64)
    lut[np.frombuffer(b"CGT", np.uint8)] = [1, 2, 3]
    shifts = np.arange(2 * (u.shape[1] - 1), -1, -2, dtype=np.uint64)
    return (lut[u] << shifts).sum(axis=1, dtype=np.uint64)


def bed_dubits(base, n, rows):
    """The PLINK bed's genotype dubits (len(rows), n) of SNP rows `rows`
    (presence 3, absence 0, as core/formats.py writes them)."""
    bpr = (n + 3) // 4
    body = np.fromfile(base + ".bed", np.uint8, offset=3).reshape(-1, bpr)
    sel = body[rows]
    shifts = np.arange(4, dtype=np.uint8) * 2
    return ((sel[:, :, None] >> shifts) & np.uint8(3)).reshape(
        len(rows), -1)[:, :n]


def read_table_rows(base):
    """(k-mer codes, (rows, words) presence words) of a .table file."""
    n, = struct.unpack_from("<Q", open(base + ".table", "rb").read(12), 4)
    words = 1 + (n + 63) // 64
    body = np.fromfile(base + ".table", "<u8",
                       offset=TABLE_HEADER.size).reshape(-1, words)
    return body[:, 0], body[:, 1:]


def table_bits(words, cols):
    """Presence bits (rows, len(cols)) of the table's columns `cols`."""
    cols = np.asarray(cols)
    return ((words[:, cols // 64] >> (cols % 64).astype(np.uint64))
            & np.uint64(1)).astype(np.uint8)


def kinship_oracle(base, n, maf, chunk=1 << 18, device="cuda"):
    """f64 recomputation of a table's kinship with plain torch on `device`
    (none of the port's code): the bits of the rows with ceil(maf n) <= N1
    <= n - ceil(maf n) as +-1, their Gram in float64 (integers, exact in
    any order), then the XNOR fraction (rows + G) / 2 / rows with the
    diagonal 1 (emma_kinship_kmers.cpp:95-102)."""
    import torch
    wf = (n + 63) // 64
    raw = np.memmap(base + ".table", dtype="<u8", mode="r",
                    offset=TABLE_HEADER.size).reshape(-1, 1 + wf)
    mc = math.ceil(n * maf)
    shifts = torch.arange(8, dtype=torch.uint8, device=device)
    G = torch.zeros((n, n), dtype=torch.float64, device=device)
    rows = 0
    for s in range(0, raw.shape[0], chunk):
        blk = torch.from_numpy(np.ascontiguousarray(raw[s:s + chunk, 1:])
                               .view(np.uint8)).to(device)
        bits = ((blk[:, :, None] >> shifts) & 1).reshape(
            blk.shape[0], -1)[:, :n].to(torch.float64)
        pc = bits.sum(1)
        a = 2 * bits[(pc >= mc) & (pc <= n - mc)] - 1
        G += a.T @ a
        rows += a.shape[0]
        del blk, bits, a
    k = (rows + G.cpu().numpy()) / 2.0 / float(rows)
    np.fill_diagonal(k, 1.0)
    return k, rows


def phase_ingest(workdir, env, n_acc=INGEST_ACCESSIONS,
                 genome_len=INGEST_GENOME, n_numpy=INGEST_NUMPY,
                 n_perm=100, top=10001, batch=2_000_000, device="cuda",
                 timeout=900):
    """Reads to results through the port's CLI (phase 21): the reference's
    E. coli example at its published shape (241 accessions, k = 31, MAC 5,
    -p 0.2) on simulated genomes of 500 kb (cut from ~5 Mb), mutated along
    a random tree, a 300-bp cassette in half of them, phenotype = 3 x
    carrier + N(0, 0.5), reads at 5x coverage of 100 bp, half
    reverse-complemented.

      1. `count` twice per accession (canonized with min_count 2, and as
         read) and `strand-merge`, the accessions in a thread pool (the
         native library runs without the GIL);
      2. `list-kmers` and `build-table` over all accessions;
      3. on n_numpy accessions the same steps with --no-native: every
         artifact byte-identical to the native route's;
      4. `gwas --device cuda`: kinship from the table (K7), 100
         permutations, top-10001, host64, --certify_topk (the scan K1,
         K2); the cassette's k-mers past threshold_5per; the kinship
         equal to a float64 Gram of the table bit for bit, every column
         certified, and 4 columns' top-k equal to the f64 oracle's on the
         transformed phenotypes it wrote;
      5. `gwas-mp` in 2 processes sharing the card with the same
         arguments (distributed kinship K7, scan K3): every artifact
         byte-identical to step 4's but summary.json (n_processes) and
         log_file, every column certified, the distributed kinship equal
         to the float64 Gram;
      6. `table-to-bed -u` and `filter-kmers` on the passing k-mers: their
         presence bits equal the table's rows;
      7. `kmc-export` -> `kmc-import` of one count file (the same bytes)
         and `histogram` of it.
    Smaller arguments and device="cpu" rehearse the phase without a
    card."""
    import concurrent.futures
    import contextlib
    import io
    import socket
    import torch
    from kmersgwas_tpu_torch import native
    from kmersgwas_tpu_torch.cli.__main__ import main as cli
    from kmersgwas_tpu_torch.core import codec, formats
    from kmersgwas_tpu_torch.ops import kinship as kin_ops
    from kmersgwas_tpu_torch.ops import score
    from kmersgwas_tpu_torch.pipeline import gwas as gwas_mod
    from kmersgwas_tpu_torch.pipeline import kinship as km
    from kmersgwas_tpu_torch.pipeline import scan
    t_phase = time.perf_counter()
    walls = {}
    k = INGEST_K
    d = os.path.join(workdir, "ingest")
    os.makedirs(d)
    try:
        native.load_ingest()
    except native.NativeUnavailable as e:
        raise PhaseError(f"ingest: the native ingest library does not "
                         f"build here:\n{e}") from None
    cores = os.cpu_count()
    log(f"ingest: {n_acc} accessions, genomes of {genome_len} bases, "
        f"k={k}, {INGEST_COVERAGE}x coverage of {INGEST_READ}-bp reads, "
        f"host cores {cores}; {env['card']}")

    # the population: a root genome, substitutions along a random tree,
    # the cassette in a random half
    rng = np.random.default_rng(21)
    root = rng.integers(0, 4, size=genome_len, dtype=np.uint8)
    parent = simulate_tree(rng, n_acc)
    n_edges = len(parent) - 1
    n_mut = rng.poisson(INGEST_TREE_MUTATIONS, size=len(parent))
    n_mut[parent < 0] = 0
    muts = [(rng.integers(0, genome_len, size=m),
             rng.integers(1, 4, size=m).astype(np.uint8)) for m in n_mut]
    cassette = rng.integers(0, 4, size=INGEST_CASSETTE, dtype=np.uint8)
    carrier = np.zeros(n_acc, bool)
    carrier[rng.choice(n_acc, n_acc // 2, replace=False)] = True
    y = 3.0 * carrier + rng.normal(scale=0.5, size=n_acc)
    names = [f"acc{s:03d}" for s in range(n_acc)]
    pheno = os.path.join(d, "resistance.pheno")
    write_phenotypes(pheno, ["phenotype_value"], names, y[:, None])
    ins = genome_len // 2

    def genome_of(s):
        g = root.copy()
        node = s
        while parent[node] >= 0:
            pos, shift = muts[node]
            np.add.at(g, pos, shift)
            node = parent[node]
        g &= 3
        if carrier[s]:
            g = np.concatenate([g[:ins], cassette, g[ins:]])
        return g

    def one_accession(s):
        base = os.path.join(d, names[s])
        reads = base + ".fq"
        write_fastq(reads, genome_of(s), np.random.default_rng([21, s]),
                    INGEST_COVERAGE, INGEST_READ)
        # stdout and stderr go where the pool's caller redirected them
        cli(["count", "-k", str(k), "-o", base + ".canon", "--canonize",
             "--min_count", "2", reads])
        cli(["count", "-k", str(k), "-o", base + ".nonc", reads])
        cli(["strand-merge", "-c", base + ".canon", "-n", base + ".nonc",
             "-k", str(k), "-o", base + ".kmers"])
        return os.path.getsize(reads)

    # 1. count + strand-merge, the accessions in a thread pool
    out, err = io.StringIO(), io.StringIO()
    t1 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err), \
            concurrent.futures.ThreadPoolExecutor(cores) as ex:
        read_bytes = sum(ex.map(one_accession, range(n_acc)))
    walls["simulate+count+strand-merge"] = time.perf_counter() - t1
    text, etext = out.getvalue(), err.getvalue()
    need(len(re.findall(r"\d+ distinct k-mers", text)) == 2 * n_acc
         and len(re.findall(r"\d+ k-mers written", text)) == n_acc,
         f"ingest: count/strand-merge stdout:\n{text[-2000:]}")
    need(etext.count("native route") == 3 * n_acc
         and "numpy route" not in etext,
         f"ingest: not every call took the native route:\n{etext[-2000:]}")
    log(f"ingest: count x2 + strand-merge of {n_acc} accessions "
        f"({read_bytes / 2**30:.2f} GiB of FASTQ, {n_edges} tree edges, "
        f"{int(n_mut.sum())} substitutions), {cores} threads: "
        f"{walls['simulate+count+strand-merge']:.1f} s with the reads' "
        f"simulation")

    # 2. the master list and the table
    lst = os.path.join(d, "kmers_list_paths.txt")
    with open(lst, "w") as f:
        f.writelines(f"{os.path.join(d, a)}.kmers {a}\n" for a in names)
    t1 = time.perf_counter()
    o1, _ = cli_run(["list-kmers", "-l", lst, "-k", str(k), "--mac",
                     str(INGEST_MAC), "-p", str(INGEST_P), "-o",
                     os.path.join(d, "kmers_to_use")])
    walls["list-kmers"] = time.perf_counter() - t1
    t1 = time.perf_counter()
    table = os.path.join(d, "kmers_table")
    o2, _ = cli_run(["build-table", "-l", lst, "-k", str(k), "-a",
                     os.path.join(d, "kmers_to_use"), "-o", table])
    walls["build-table"] = time.perf_counter() - t1
    n_rows = int(o2.split()[1])
    need(o1.strip() == f"passed kmers:\t{n_rows}",
         f"ingest: list-kmers said {o1!r}, build-table {o2!r}")
    table_bytes = os.path.getsize(table + ".table")
    log(f"ingest: list-kmers {walls['list-kmers']:.1f} s, build-table "
        f"{walls['build-table']:.1f} s: {n_rows} rows, {table_bytes} bytes "
        f"({table_bytes / 2**20:.1f} MiB)")

    # 3. the numpy route on n_numpy accessions: the same bytes. Its counter
    # is a Python loop over reads, which holds the GIL: each accession's
    # three calls run in a process of their own, all at once
    t1 = time.perf_counter()
    sub = list(range(n_numpy))
    code = ("import sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from kmersgwas_tpu_torch.cli.__main__ import main\n"
            "b, k = sys.argv[1], sys.argv[2]\n"
            "main(['count', '-k', k, '-o', b + '.np.canon', '--canonize', "
            "'--min_count', '2', b + '.fq', '--no-native'])\n"
            "main(['count', '-k', k, '-o', b + '.np.nonc', b + '.fq', "
            "'--no-native'])\n"
            "main(['strand-merge', '-c', b + '.np.canon', '-n', "
            "b + '.np.nonc', '-k', k, '-o', b + '.np.kmers', "
            "'--no-native'])\n")
    procs = [subprocess.Popen(
        [sys.executable, "-c", code, os.path.join(d, names[s]), str(k)],
        cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for s in sub]
    try:
        logs = [pr.communicate(timeout=timeout)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for s, pr, text in zip(sub, procs, logs):
        need(pr.returncode == 0 and text.count("numpy route") == 3,
             f"ingest: the numpy route failed:\n{text[-3000:]}")
        base = os.path.join(d, names[s])
        want = [f"{os.path.getsize(base + '.canon') // 16} distinct k-mers",
                f"{os.path.getsize(base + '.nonc') // 16} distinct k-mers",
                f"{os.path.getsize(base + '.kmers') // 8} k-mers written"]
        need([ln for ln in text.splitlines() if "k-mers" in ln] == want,
             f"ingest: the numpy route's stdout {text!r}, native {want}")
    diff = []
    for s in sub:
        base = os.path.join(d, names[s])
        for ext in (".canon", ".nonc", ".kmers"):
            if open(base + ext, "rb").read() != \
                    open(base + ".np" + ext, "rb").read():
                diff.append(names[s] + ext)
    outs = {}
    for route, tag, flag in (("native", "", []),
                             ("numpy", ".np", ["--no-native"])):
        sl = os.path.join(d, f"sub{tag}.txt")
        with open(sl, "w") as f:
            f.writelines(f"{os.path.join(d, names[s])}{tag}.kmers "
                         f"{names[s]}\n" for s in sub)
        m = os.path.join(d, f"sub{tag}.master")
        t = os.path.join(d, f"sub{tag}.table_base")
        a, _ = cli_run(["list-kmers", "-l", sl, "-k", str(k), "--mac",
                        str(INGEST_MAC), "-p", str(INGEST_P), "-o", m,
                        *flag])
        b, _ = cli_run(["build-table", "-l", sl, "-k", str(k), "-a", m,
                        "-o", t, *flag])
        outs[route] = [a, b] + [
            open(p, "rb").read() for p in
            [m + sfx for sfx in ("", ".no_pass_kmers", ".shareness",
                                 ".stats.only_canonical",
                                 ".stats.only_non_canonical",
                                 ".stats.both")]
            + [t + ".table", t + ".names"]]
    walls["numpy route"] = time.perf_counter() - t1
    need(not diff, f"ingest: the numpy route's bytes differ: {diff}")
    need(outs["native"] == outs["numpy"],
         "ingest: list-kmers/build-table differ between the routes")
    log(f"ingest: the numpy route on {n_numpy} accessions (count x2, "
        f"strand-merge, list-kmers, build-table): every artifact and "
        f"stdout byte-identical to the native route's "
        f"({walls['numpy route']:.1f} s)")

    # 4. gwas on the card, in this process
    args = ["--pheno", pheno, "--kmers_table", table, "-l", str(k), "-k",
            str(top), "--permutations", str(n_perm), "--mac",
            str(INGEST_MAC), "--batch_size", str(batch), "--lmm_backend",
            "host64", "--certify_topk", "--device", device]
    counters = (score.score_batch_t_topw, score.score_batch_t_bmax,
                score.score_batch_t_tilemax, kin_ops.kinship_accumulate,
                kin_ops.transpose_bits)
    for c in counters:
        c.launches = 0
    t1 = time.perf_counter()
    one_out = os.path.join(d, "gwas_one")
    with Capture(gwas_mod.transform_mod, "transform_and_permute") as c_tr, \
            Capture(gwas_mod.scan_mod, "associate") as c_sr:
        o, _ = cli_run(["gwas", "--outdir", one_out, *args])
    gwas_line = o.strip()
    if device == "cuda":
        torch.cuda.synchronize()
    walls["gwas"] = time.perf_counter() - t1
    tr, sr = c_tr.calls[0], c_sr.calls[0]
    k1, k2, k3, k7, k7t = (c.launches for c in counters)
    need(k1 >= 1 and k7 >= 1 and k3 == 0 or device != "cuda",
         f"ingest: gwas launched K1 {k1}, K2 {k2}, K3 {k3}, K7 {k7}")
    log(f"ingest: gwas --device {device}: {o.strip()} "
        f"({walls['gwas']:.1f} s; K1 {k1}, K2 {k2}, K7 {k7}, K7's "
        f"transpose {k7t})")
    passed = [ln.split("\t")[0] for ln in open(os.path.join(
        one_out, "kmers", "pass_threshold_5per")).read().splitlines()]
    flank = root[ins - k + 1:ins + k - 1]
    cas = canonical_kmers(np.concatenate(
        [flank[:k - 1], cassette, flank[k - 1:]]), k)
    kmers_all, words = read_table_rows(table)
    cas_in_table = np.intersect1d(cas, kmers_all)
    pass_codes = (codec.encode_kmers(passed) if passed
                  else np.empty(0, np.uint64))
    cas_pass = np.intersect1d(cas_in_table, pass_codes)
    log(f"ingest: {len(passed)} k-mers pass threshold_5per, "
        f"{len(cas_pass)} of the cassette's {len(cas)} k-mers ("
        f"{len(cas_in_table)} in the table)")
    need(len(cas_in_table) > 0 and 2 * len(cas_pass) >= len(cas_in_table),
         "ingest: the cassette's k-mers did not pass threshold_5per")

    # the kernels of step 4 against plain references on the same inputs:
    # K7's kinship (cached beside the table) against a float64 Gram, the
    # scan's certified top-k (K1, K2) against the f64 oracle on the
    # float32-cast transformed phenotypes, as phase 4 holds them
    t1 = time.perf_counter()
    need(formats.read_names(table) == names, "ingest: the table's names")
    K_ref, kin_rows = kinship_oracle(table, n_acc, 0.05, device=device)
    K_one = km.read_kinship(table + ".kinship")
    need(np.array_equal(K_one, K_ref),
         f"gwas: kinship differs from the f64 Gram in "
         f"{int((K_one != K_ref).sum())} entries")
    pcs = np.unpackbits(np.ascontiguousarray(words).view(np.uint8),
                        axis=1).sum(1, dtype=np.int64)
    mc = scan.effective_min_count(n_acc, 0.05, INGEST_MAC)
    keep = (pcs >= mc) & (pcs <= n_acc - mc)
    need(sr.n_tested == int(keep.sum()),
         f"gwas: {sr.n_tested} k-mers tested, {int(keep.sum())} pass MAC")
    need(sr.certified is not None and len(sr.certified) == 1 + n_perm
         and all(sr.certified),
         f"gwas: certified {sum(sr.certified or [])} of {1 + n_perm} "
         f"columns")
    cols = (0, 1, n_perm // 2, n_perm)
    oracle = oracle_top(table, n_acc,
                        tr.transformed[:, cols].astype(np.float32), keep,
                        top, device=device)
    for j, (bv, br) in zip(cols, oracle):
        need(np.array_equal(sr.rows[j], br),
             f"gwas: column {j}: rows differ from the f64 oracle "
             f"({np.sum(sr.rows[j] != br)} of {len(br)})")
        need(np.allclose(sr.scores[j], bv, rtol=1e-12, atol=0),
             f"gwas: column {j}: scores differ from the f64 oracle")
    walls["gwas oracles"] = time.perf_counter() - t1
    log(f"ingest: gwas's kinship (K7) equal to the f64 Gram of its "
        f"{kin_rows} rows bit for bit; all {1 + n_perm} columns certified; "
        f"columns {list(cols)}: top-{top} rows and scores equal the f64 "
        f"oracle's ({walls['gwas oracles']:.1f} s)")

    # 5. gwas-mp: 2 processes sharing the card, the same arguments; the
    # kinship cached beside the table by step 4 is removed, so the
    # distributed kinship runs
    os.remove(table + ".kinship")
    if device == "cuda":
        torch.cuda.empty_cache()        # the card is shared with the ranks
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    mp_out = os.path.join(d, "gwas_mp")
    code = ("import json, sys\n"
            f"sys.path.insert(0, {ROOT!r})\n"
            "from kmersgwas_tpu_torch.cli.__main__ import main\n"
            "from kmersgwas_tpu_torch.ops import kinship as kin, score\n"
            "cs = {'k1': score.score_batch_t_topw, "
            "'k2': score.score_batch_t_bmax, "
            "'k3': score.score_batch_t_tilemax, "
            "'k7': kin.kinship_accumulate, 'k7t': kin.transpose_bits}\n"
            "from kmersgwas_tpu_torch.pipeline import scan as sc\n"
            "sel, cert = sc.select_candidates, []\n"
            "def select(*a, **kw):\n"
            "    r = sel(*a, **kw)\n"
            "    cert.append(r[3])\n"
            "    return r\n"
            "sc.select_candidates = select\n"
            "for c in cs.values():\n"
            "    c.launches = 0\n"
            "main(sys.argv[1:])\n"
            "print('certified ' + json.dumps("
            "[c if c is None else [bool(x) for x in c] for c in cert]))\n"
            "print('launches ' + json.dumps("
            "{n: c.launches for n, c in cs.items()}))\n")
    cmd = [sys.executable, "-c", code, "gwas-mp", "--outdir", mp_out, *args,
           "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2"]
    t1 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--process_id", str(i)], cwd=ROOT,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for i in range(2)]
    try:
        logs = [pr.communicate(timeout=timeout)[0] for pr in procs]
    finally:
        for pr in procs:                # a failed or hung rank: stop all
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    walls["gwas-mp"] = time.perf_counter() - t1
    for i, (pr, text) in enumerate(zip(procs, logs)):
        need(pr.returncode == 0, f"gwas-mp: rank {i} exited "
             f"{pr.returncode}:\n{text[-3000:]}")
    ranks = [json.loads(last_line(t, "launches ").split(" ", 1)[1])
             for t in logs]
    cert = [json.loads(last_line(t, "certified ").split(" ", 1)[1])
            for t in logs]
    need(len(cert[0]) == 1 and cert[0][0] is not None
         and len(cert[0][0]) == 1 + n_perm and all(cert[0][0])
         and cert[1] == [],
         f"gwas-mp: the selection's certified flags per rank: {cert}")
    mp = {c: sum(r[c] for r in ranks) for c in ranks[0]}
    lines = [last_line(t, "threshold_5per=" if i == 0 else "process 1:")
             for i, t in enumerate(logs)]
    log(f"ingest: gwas-mp 2 processes --device {device}: {lines[0]} | "
        f"{lines[1]} ({walls['gwas-mp']:.1f} s; K3 {mp['k3']}, K2 "
        f"{mp['k2']}, K7 {mp['k7']}, K7's transpose {mp['k7t']}, K1 "
        f"{mp['k1']})")
    need(lines[0] == o.strip(),
         f"gwas-mp: process 0 said {lines[0]!r}, gwas {o.strip()!r}")
    need(mp["k3"] >= 2 and mp["k7"] >= 2 and mp["k1"] == 0
         and all(r["k7"] >= 1 and r["k3"] >= 1 for r in ranks)
         or device != "cuda",
         f"gwas-mp: launches per rank {ranks}")
    K_mp = km.read_kinship(table + ".kinship")
    need(np.array_equal(K_mp, K_ref),
         f"gwas-mp: the distributed kinship differs from the f64 Gram in "
         f"{int((K_mp != K_ref).sum())} entries")
    a, b = gwas_outputs(mp_out), gwas_outputs(one_out)
    need(sorted(a) == sorted(b), f"gwas-mp: files differ: {sorted(a)} vs "
         f"{sorted(b)}")
    diff = [f for f in b if f not in ("summary.json", "log_file")
            and a[f] != b[f]]
    need(not diff, f"gwas-mp: artifacts differ from gwas's: {diff}")
    sa, sb = (json.loads(x["summary.json"]) for x in (a, b))
    need(sa.pop("n_processes") == 2 and sorted(sa) == sorted(sb) and all(
        sa[key] == sb[key] for key in sb if key != "stage_seconds"),
        "gwas-mp: summary.json differs from gwas's")
    log(f"ingest: gwas-mp wrote gwas's {len(b) - 2} artifacts byte for "
        "byte (assoc.txt.gz, thresholds, pass files, bed/bim/fam, "
        "kinship, phenotypes; so its scan, K3, holds gwas's oracle-checked "
        "top-k); summary.json equal but n_processes 2 and the stage "
        f"times; all {1 + n_perm} columns certified; the distributed "
        "kinship (K7) equal to the f64 Gram bit for bit")

    # 6. exports of the passing k-mers against the table
    t1 = time.perf_counter()
    qfile = os.path.join(d, "passed.txt")
    with open(qfile, "w") as f:
        f.write("\n".join(passed) + "\n")
    o, _ = cli_run(["filter-kmers", "-t", table, "-k", qfile, "-o",
                    os.path.join(d, "passed.presence")])
    need(o.strip() == f"found {len(passed)} of {len(passed)}",
         f"filter-kmers: {o!r}")
    rows = np.searchsorted(kmers_all, pass_codes)
    pres = [ln.split("\t") for ln in open(os.path.join(
        d, "passed.presence")).read().splitlines()]
    need(pres[0] == ["kmer"] + names, "filter-kmers: header")
    order = np.argsort(rows)
    got = np.array([[int(x) for x in r[1:]] for r in pres[1:]], np.uint8)
    need([r[0] for r in pres[1:]] == [passed[i] for i in order]
         and np.array_equal(got.reshape(len(passed), n_acc),
                            table_bits(words[rows[order]],
                                       np.arange(n_acc))),
         "filter-kmers: presence differs from the table's rows")
    o, _ = cli_run(["table-to-bed", "-t", table, "-p", pheno, "--maf",
                    "0.05", "--mac", str(INGEST_MAC), "-b", str(1 << 20),
                    "-u", "-o", os.path.join(d, "bed")])
    n_var = int(o.split()[1])
    got_rows, checked = 0, 0
    shard = 0
    while os.path.exists(os.path.join(d, f"bed.{shard}.bed")):
        sb_ = os.path.join(d, f"bed.{shard}")
        need(formats.read_fam_names(sb_ + ".fam") == names,
             "table-to-bed: fam order")
        with open(sb_ + ".bim") as f:
            codes = encode_kmer_strings(
                [ln.split("\t", 2)[1] for ln in f])
        pick = np.nonzero(np.isin(codes, pass_codes))[0]
        extra = np.random.default_rng(shard).choice(
            len(codes), size=min(4096, len(codes)), replace=False)
        pick = np.union1d(pick, extra)
        r = np.searchsorted(kmers_all, codes[pick])
        need(np.array_equal(kmers_all[r], codes[pick]) and np.array_equal(
            bed_dubits(sb_, n_acc, pick),
            3 * table_bits(words[r], np.arange(n_acc))),
            f"table-to-bed: shard {shard} differs from the table's rows")
        got_rows += len(codes)
        checked += len(pick)
        shard += 1
    need(got_rows == n_var > 0, f"table-to-bed: {o!r}, {got_rows} rows")
    walls["exports"] = time.perf_counter() - t1
    log(f"ingest: filter-kmers of the {len(passed)} passing k-mers and "
        f"table-to-bed -u ({n_var} variants in {shard} shards; "
        f"{checked} rows checked, the passing k-mers among them): presence "
        f"equal to the table's rows ({walls['exports']:.1f} s)")

    # 7. KMC round trip and histogram of one count file
    t1 = time.perf_counter()
    counts = os.path.join(d, names[0] + ".canon")
    kdb = os.path.join(d, "kmc_db")
    cli_run(["kmc-export", counts, "-k", str(k), "-o", kdb])
    o, _ = cli_run(["kmc-import", kdb, "-o", kdb + ".counts"])
    need(open(kdb + ".counts", "rb").read() == open(counts, "rb").read(),
         "kmc-export -> kmc-import changed the count file")
    h, _ = cli_run(["histogram", counts])
    hist = [ln.split("\t") for ln in h.splitlines()[1:]]
    n_distinct = os.path.getsize(counts) // 16
    need(sum(int(c) for _, c in hist) == n_distinct and hist[1][1] == "0",
         "histogram: counts do not sum to the distinct k-mers")
    walls["kmc+histogram"] = time.perf_counter() - t1
    log(f"ingest: kmc-export -> kmc-import of {names[0]}'s canonized "
        f"counts ({o.strip()}) byte-identical; histogram over "
        f"{len(hist)} counts ({walls['kmc+histogram']:.1f} s)")
    walls["phase"] = time.perf_counter() - t_phase
    log("ingest: walls " + json.dumps({w: round(v, 2)
                                        for w, v in walls.items()}))
    return dict(k1=k1, k2=k2 + mp["k2"], k3=mp["k3"], k7=k7 + mp["k7"],
                k7t=k7t + mp["k7t"], walls=walls, rows=n_rows,
                table_bytes=table_bytes, table=table, args=args,
                one_out=one_out, line=gwas_line, code=code)


def last_line(text, prefix):
    """The last line of `text` that starts with `prefix` ("" if none)."""
    hits = [ln for ln in text.splitlines() if ln.startswith(prefix)]
    return hits[-1] if hits else ""


# ---------------------------------------------------------------- phase 22

def cli_files(out):
    """{path relative to out: bytes} of every file under out, times
    aside: a gwas run's log_file, and its summary.json without its
    stage_seconds."""
    files = gwas_outputs(out)
    files.pop("log_file", None)
    if "summary.json" in files:
        sm = json.loads(files["summary.json"])
        sm.pop("stage_seconds")
        files["summary.json"] = json.dumps(sm, sort_keys=True).encode()
    return files


def phase_mesh(main, kin, workdir, shards=(2, 4), device="cuda"):
    """The single-process device mesh (phase 22), its shards all on the
    one card (sharding.make_mesh([cuda:0] * D)), so the sharded path runs
    for real: per-shard states, per-shard kernel launches, the cross-shard
    merge at finalize.

      a. `associate(mesh=)` with D = 2 and 4 on phase 3's table and
         arguments (certify_topk): every column certified, the same rows
         in the same order as phase 3's single-device result and the f64
         re-scores bit-equal; K1 launched D times a batch;
      b. `kinship_from_table(mesh=)` with 2 shards: phase 8's K bit for
         bit (K7 on each shard);
      c. the CLI `associate`, `kinship` and `gwas` with `--devices 2` on
         phase 5's table (phase 18's phenotype for gwas): stdout and every
         file byte-identical to `--devices 1` (summary.json but its stage
         times).
    The K1, K2 and K7 counts of the phase are returned; each must be
    positive."""
    from kmersgwas_tpu_torch.ops import kinship as kin_ops
    from kmersgwas_tpu_torch.ops import score
    from kmersgwas_tpu_torch.parallel import sharding
    from kmersgwas_tpu_torch.pipeline import kinship as km
    from kmersgwas_tpu_torch.pipeline import scan
    cuda = device == "cuda"
    counters = {"k1": score.score_batch_t_topw,
                "k2": score.score_batch_t_bmax,
                "k7": kin_ops.kinship_accumulate,
                "k7t": kin_ops.transpose_bits}
    for c in counters.values():
        c.launches = 0
    ref = main["res"]
    n_batches = -(-main["n_tested"] // main["batch"])
    walls = {}

    # a. associate over D shards of the card
    for d in shards:
        mesh = sharding.make_mesh([device] * d)
        k1 = score.score_batch_t_topw.launches
        t0 = time.perf_counter()
        res = scan.associate(main["base"], main["names"], main["y"],
                             main["cols"], kmer_len=main["kmer_len"],
                             device=device, dtable_cache=main["dtable"],
                             n_top=main["k"], batch_size=main["batch"],
                             certify_topk=True, mesh=mesh,
                             progress=lambda r: None)
        walls[f"associate D={d}"] = time.perf_counter() - t0
        k1 = score.score_batch_t_topw.launches - k1
        st = res.steps
        log(f"mesh: associate over {d} shards of {device}: wall "
            f"{walls[f'associate D={d}']:.2f} s (phase 3: one device), "
            f"timings " + json.dumps({a: round(b, 4)
                                      for a, b in res.timings.items()})
            + f"; step ms median {1e3 * statistics.median(st['step_s']):.2f}"
            f" over {len(st['step_s'])}; shard steps narrow {st['narrow']} "
            f"wide {st['wide']} fallback {st['fallback']} flush "
            f"{st['flush']}; K1 launches {k1}")
        need(k1 == d * n_batches or not cuda,
             f"mesh: K1 launched {k1} times for {d} x {n_batches} shard "
             "batches")
        need(res.n_tested == ref.n_tested and all(res.certified),
             f"mesh D={d}: n_tested {res.n_tested}, certified "
             f"{sum(res.certified)}/{len(res.certified)}")
        bad = [j for j in range(len(ref.rows))
               if not (np.array_equal(res.rows[j], ref.rows[j])
                       and np.array_equal(res.scores[j], ref.scores[j]))]
        need(not bad, f"mesh D={d}: columns {bad[:5]} differ from the "
             "single-device run")
        log(f"mesh: D={d}: all {len(ref.rows)} columns certified, rows, "
            f"order and f64 re-scores equal the single-device run's")

    # b. kinship over 2 shards
    mesh = sharding.make_mesh([device] * 2)
    k7 = kin_ops.kinship_accumulate.launches
    t0 = time.perf_counter()
    K = km.kinship_from_table(main["base"], device=device, maf=0.05,
                              batch_size=1 << 20, mesh=mesh,
                              dtable_cache=main["dtable"])
    walls["kinship D=2"] = time.perf_counter() - t0
    k7 = kin_ops.kinship_accumulate.launches - k7
    need(np.array_equal(K, kin["K"]),
         f"mesh: kinship differs from phase 8's in "
         f"{int((K != kin['K']).sum())} entries")
    need(k7 >= 2 * -(-main["n_tested"] // (1 << 20)) - 1 or not cuda,
         f"mesh: K7 launched {k7} times")
    log(f"mesh: kinship over 2 shards equals phase 8's bit for bit "
        f"({walls['kinship D=2']:.2f} s, K7 launches {k7})")

    # c. the CLI with --devices 2 against --devices 1
    small = os.path.join(workdir, "small")
    pheno = os.path.join(workdir, "small.pheno")
    gpheno = os.path.join(workdir, "gwas_small.pheno")
    need(os.path.exists(gpheno), "mesh: phase 18's phenotype is missing")
    for cmd in ("associate", "kinship", "gwas"):
        outs = []
        for d in (1, 2):
            out = os.path.join(workdir, f"mesh_{cmd}_{d}")
            os.makedirs(out)
            argv = {
                "associate": ["associate", "-p", pheno, "-b", "small", "-o",
                              out, "--kmers_table", small, "-n", "100",
                              "--batch_size", "4096", "--kmer_len", "31",
                              "--pattern_counter", "--kmers_scores"],
                "kinship": ["kinship", "-t", small, "--maf", "0.05",
                            "--batch_size", "4096"],
                "gwas": ["gwas", "--pheno", gpheno, "--kmers_table", small,
                         "--outdir", out, "-l", "31", "-k", "100",
                         "--permutations", "10", "--batch_size", "4096",
                         "--certify_topk"],
            }[cmd] + ["--device", device, "--devices", str(d)]
            if os.path.exists(small + ".kinship"):
                os.remove(small + ".kinship")   # each gwas computes kinship
            t0 = time.perf_counter()
            o, _ = cli_run(argv)
            walls[f"{cmd} --devices {d}"] = time.perf_counter() - t0
            outs.append((o, cli_files(out)))
        (o1, f1), (o2, f2) = outs
        need(o1 == o2 and o1, f"mesh: {cmd} --devices 2 printed {o2!r}, "
             f"--devices 1 {o1!r}")
        diff = sorted(set(f1) ^ set(f2)) + [f for f in f1 if f in f2
                                             and f1[f] != f2[f]]
        need(not diff, f"mesh: {cmd} --devices 2 differs: {diff}")
        log(f"mesh: {cmd} --devices 2 --device {device}: stdout and "
            f"{len(f1)} files byte-identical to --devices 1 "
            f"({walls[f'{cmd} --devices 1']:.1f} / "
            f"{walls[f'{cmd} --devices 2']:.1f} s)")
    launches = {name: c.launches for name, c in counters.items()}
    need(all(launches.values()) or not cuda,
         f"mesh: a kernel of the sharded path never launched: {launches}")
    log("mesh: launches " + json.dumps(launches) + "; walls "
        + json.dumps({a: round(b, 2) for a, b in walls.items()}))
    return launches


# ---------------------------------------------------------------- phase 23

def phase_crash_resume(ing, workdir, n_proc=8, batch=100_000, device="cuda",
                       timeout=600):
    """`gwas-mp` killed with SIGKILL mid-scan and resumed (phase 23): the
    command of phase 21's `gwas` with --checkpoint (every batch) and
    batches of `batch` rows (several per process), in n_proc processes
    sharing the card, on phase 21's table with its cached kinship removed
    (so the killed attempt runs the distributed kinship, K7, and its
    process 0 caches the matrix beside the table, where the resumed run
    reads it). Every process is killed once all n_proc scan checkpoints
    exist while every process still runs; the same command is run again
    and must end 0 and write phase 21's `gwas` artifacts byte for byte
    (summary.json but n_processes and the stage times), every column
    certified. Returns the resumed ranks' launches (K3 and K2; K7 none,
    the kinship being cached)."""
    import signal
    import socket
    args = list(ing["args"])
    args[args.index("--batch_size") + 1] = str(batch)
    table = ing["table"]
    if os.path.exists(table + ".kinship"):
        os.remove(table + ".kinship")
    ck = os.path.join(workdir, "crash_ck")
    out = os.path.join(workdir, "crash_mp")
    scan_cks = [f"{ck}.scan.p{i}.npz" for i in range(n_proc)]
    walls = {}

    def launch():
        with socket.socket() as sk:
            sk.bind(("127.0.0.1", 0))
            port = sk.getsockname()[1]
        cmd = [sys.executable, "-c", ing["code"], "gwas-mp", "--outdir",
               out, *args, "--checkpoint", ck, "--checkpoint_every", "1",
               "--coordinator", f"127.0.0.1:{port}", "--num_processes",
               str(n_proc)]
        return [subprocess.Popen(cmd + ["--process_id", str(i)], cwd=ROOT,
                                 stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)
                for i in range(n_proc)]

    t0 = time.perf_counter()
    procs = launch()
    try:
        while time.perf_counter() - t0 < timeout and all(
                pr.poll() is None for pr in procs):
            if all(os.path.exists(p) for p in scan_cks):
                break
            time.sleep(0.05)
        alive = all(pr.poll() is None for pr in procs)
        ready = all(os.path.exists(p) for p in scan_cks)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(signal.SIGKILL)
        logs = [pr.communicate()[0] for pr in procs]
    walls["killed"] = time.perf_counter() - t0
    need(alive and ready, "crash: the checkpoints never all appeared while "
         "every process ran:\n" + "\n".join(x[-1500:] for x in logs))
    need(all(pr.returncode == -signal.SIGKILL for pr in procs),
         f"crash: exit codes {[pr.returncode for pr in procs]}")
    need(not os.path.exists(os.path.join(out, "kmers", "threshold_5per")),
         "crash: results were written before the kill")
    tested = [int(np.load(p)["n_tested"]) for p in scan_cks]
    log(f"crash: {n_proc} gwas-mp processes SIGKILLed "
        f"{walls['killed']:.1f} s after their start, their scan "
        f"checkpoints holding {sum(tested)} tested k-mers ({tested})")

    t0 = time.perf_counter()
    procs = launch()
    try:
        logs = [pr.communicate(timeout=timeout)[0] for pr in procs]
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    walls["resumed"] = time.perf_counter() - t0
    for i, (pr, text) in enumerate(zip(procs, logs)):
        need(pr.returncode == 0, f"crash: resumed rank {i} exited "
             f"{pr.returncode}:\n{text[-3000:]}")
    ranks = [json.loads(last_line(t, "launches ").split(" ", 1)[1])
             for t in logs]
    cert = json.loads(last_line(logs[0], "certified ").split(" ", 1)[1])
    mp = {c: sum(r[c] for r in ranks) for c in ranks[0]}
    line = last_line(logs[0], "threshold_5per=")
    need(line == ing["line"], f"crash: process 0 said {line!r}, phase 21's "
         f"gwas {ing['line']!r}")
    need(len(cert) == 1 and all(cert[0]), f"crash: certified {cert}")
    need(sum(tested) < int(line.split("tested=")[1]),
         "crash: the scan had ended before the kill")
    a, b = gwas_outputs(out), gwas_outputs(ing["one_out"])
    diff = sorted(set(a) ^ set(b)) + [
        f for f in b if f in a and f not in ("summary.json", "log_file")
        and a[f] != b[f]]
    need(not diff, f"crash: the resumed artifacts differ from gwas's: "
         f"{diff}")
    sa, sb = (json.loads(x["summary.json"]) for x in (a, b))
    need(sa.pop("n_processes") == n_proc and all(
        sa[key] == sb[key] for key in sb if key != "stage_seconds"),
        "crash: summary.json differs from gwas's")
    need(all(r["k3"] >= 1 for r in ranks) or device != "cuda",
         f"crash: launches per rank {ranks}")
    log(f"crash: resumed {n_proc} processes: {line}; {len(b) - 2} artifacts "
        f"byte-identical to phase 21's gwas, all {len(cert[0])} columns "
        f"certified; walls killed {walls['killed']:.1f} s, resumed "
        f"{walls['resumed']:.1f} s; ranks' launches K3 {mp['k3']}, K2 "
        f"{mp['k2']}, K7 {mp['k7']}")
    return dict(mp, walls=walls)


# ---------------------------------------------------------------- phase 24

# (tool, its arguments, its work directory's name: prof_r5_certify and
# prof_r5_feedgap share the synthetic table they build there)
TOOL_RUNS = (
    ("prof_step", ["--rows", str(1 << 20), "--iters", "10"], None),
    ("prof_r5_certify", ["1", "--rows", "1000000", "--p", "11"], "pop"),
    ("prof_r5_feedgap", ["1000000", "--batch", "250000"], "pop"),
    ("bench_ingest", ["--rows", "4e6", "--samples", "16"], "ingest"),
    ("at_scale_run", ["--rows", "1000000", "--permutations", "10", "-k",
                      "1001"], "at_scale"),
)


def phase_tools(workdir, env, runs=TOOL_RUNS, device="cuda"):
    """The five tools without a TPU kernel (phase 24), each once in a new
    process at a reduced size (TOOL_RUNS), on `device` (bench_ingest is
    host code): each must exit 0 and print JSON that parses; their lines
    and walls are logged beside the card."""
    walls = {}
    for name, argv, work in runs:
        cmd = [sys.executable, "-m", f"kmersgwas_tpu_torch.tools.{name}",
               *argv]
        if work:
            cmd += ["--workdir", os.path.join(workdir, f"tool_{work}")]
        if name != "bench_ingest":
            cmd += ["--device", device]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                              timeout=600)
        walls[name] = time.perf_counter() - t0
        need(proc.returncode == 0, f"tool {name} failed:\n"
             f"{proc.stdout[-2000:]}\n{proc.stderr[-3000:]}")
        lines = [json.loads(ln) for ln in proc.stdout.splitlines()
                 if ln.startswith("{")]
        need(lines, f"tool {name} printed no JSON")
        for ln in lines:
            log(f"tool {name}: " + json.dumps(ln))
        log(f"tool {name}: {len(lines)} JSON lines, {walls[name]:.1f} s "
            f"({env['card']})")
    return walls


# ---------------------------------------------------------------- record

def bound_ms(n_bytes, ops, ops_per_s, bytes_per_s):
    """(least time in ms, "bytes" or "operations"): the larger of the
    bytes over the HBM rate and the operations over their peak."""
    t_bytes = n_bytes / bytes_per_s * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def kernel_bounds(peaks, rows=2_097_152, n_used=1008, n_pad=1024, p=101,
                  w=256, kin_rows=1 << 20, gen_rows=1 << 21, gen_w32=32,
                  red_p=104, red_nt=128, red_tr=2048, parity_w=128,
                  gen_int_floor_ms=0.0):
    """Each kernel's bound at the shapes its time was taken at, at the
    card's peaks (`bench.CardPeaks`). Operations count what the function
    needs, not the padding: K1-K5 one flagship batch, the (R, N) x (N, P)
    score GEMM (bf16 products at precision "default"); K7 2^20 rows into
    the Gram of N samples, whose N (N + 1) / 2 entries on and above the
    diagonal are all the function needs (int8), its bit transpose the
    2^20 rows' words read and written once (bytes); K6 one generated
    batch: the planes and popcounts it writes, against its integer floor
    (gen_int_floor_ms, reckoned from the built kernel's SASS by gen_sass:
    the Philox blocks' IMAD, LOP3 and POPC instructions over their issue
    rates), "operations" where the floor is the larger; K8 one flagship
    batch, K1's GEMM, its two (P, w) lists and ok written; K9 tile_reduce
    the (104, 128 x 2048) f32 plane read and its seven (104, 128) planes
    written, tile_topc the (104, 128) maxima read
    and the sorted values and indices written: comparisons, which no
    peak counts. Bytes: each input read once, each output written once."""
    w32 = n_pad // 32
    f4 = 4
    inputs = rows * w32 * f4 + rows * f4 + n_pad * p * f4 + p * f4
    gemm = 2.0 * rows * n_used * p
    tiles = rows // 128

    def score(out_bytes):
        return bound_ms(inputs + out_bytes, gemm, peaks.bf16_flops,
                        peaks.hbm_bytes)
    return {
        "score_topw": score(p * f4 + p * w * 8 + p),
        "score_bmax": score(p * rows * f4 + p * rows // 16 * f4),
        "score_tilemax": score(p * f4 + 9 * p * tiles * f4),
        "score_t": score(p * rows * f4),
        "score_rows": score(rows * p * f4),
        "kinship_gram": bound_ms(
            kin_rows * w32 * f4 + 2 * n_pad * n_pad * f4,
            2.0 * kin_rows * n_used * (n_used + 1) / 2, peaks.int8_ops,
            peaks.hbm_bytes),
        "kinship_transpose": bound_ms(2 * kin_rows * w32 * f4, 0.0,
                                      peaks.int8_ops, peaks.hbm_bytes),
        "gen_planes": bound_ms(gen_rows * gen_w32 * f4 + gen_rows * f4,
                               gen_int_floor_ms * 1e-3, 1.0,
                               peaks.hbm_bytes),
        "score_parity": score(2 * p * parity_w * 8 + p),
        "tile_reduce": bound_ms(
            (red_p * red_nt * red_tr + red_p + 7 * red_p * red_nt) * f4, 0.0,
            peaks.int8_ops, peaks.hbm_bytes),
        "tile_topc": bound_ms(3 * red_p * red_nt * f4, 0.0, peaks.int8_ops,
                              peaks.hbm_bytes),
    }


# ---------------------------------------------------------------- main

def timed(phase, *args, **kw):
    """phase(*args, **kw), its wall time logged."""
    t0 = time.perf_counter()
    r = phase(*args, **kw)
    log(f"[{phase.__name__}] {time.perf_counter() - t0:.1f} s")
    return r


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
        from kmersgwas_tpu_torch import bench
    except ImportError as e:
        print(f"FAIL: the port is not importable from {ROOT}: {e}",
              file=sys.stderr)
        return 1
    peaks = bench.card_peaks(torch.device("cuda"))
    if peaks is None:
        print(f"FAIL: no peaks known for {torch.cuda.get_device_name(0)} "
              "(kmersgwas_tpu_torch/bench.py CARD_PEAKS)", file=sys.stderr)
        return 1
    t_start = time.perf_counter()
    build = os.path.join(ROOT, "kmersgwas_tpu_torch", "build")
    os.makedirs(build, exist_ok=True)
    workdir = tempfile.mkdtemp(prefix="smoke_", dir=build)
    try:
        env = timed(phase_env)
        kres = timed(phase_kernels)
        mres = timed(phase_main, workdir)
        timed(phase_stream, "cand_w")
        timed(phase_stream, "cand_c", n_batches=240)
        timed(phase_cli, workdir)
        pres = timed(phase_mp, mres)
        timed(phase_mp_cli, workdir, mres)
        kin = timed(phase_kinship, mres, workdir)
        timed(phase_kinship_cli, workdir)
        timed(phase_kinship_mp, workdir, mres, kin)
        bres = timed(phase_score_batch)
        gres = timed(phase_gen)
        bench_res = timed(phase_bench, workdir)
        timed(phase_at_scale, workdir)
        k9res = timed(phase_probe_kernels)
        k8res = timed(phase_probes)
        gw = timed(phase_gwas, mres, workdir, kin)
        timed(phase_gwas_cli, workdir)
        snp = timed(phase_snps, mres, workdir)
        timed(phase_emma, mres, kin)
        ing = timed(phase_ingest, workdir, env)
        mesh = timed(phase_mesh, mres, kin, workdir)
        crash = timed(phase_crash_resume, ing, workdir)
        timed(phase_tools, workdir, env)
    except PhaseError as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if "jax" in sys.modules:
        print("FAIL: jax was imported", file=sys.stderr)
        return 1
    t, e = kres["times"], kres["errs"]
    # K1, K2 and K7 run on several paths: the scan (phase 3) or kinship
    # (phase 8), gwas (phase 18), K1 and K2 gwas with the SNP arm (phase
    # 19), reads to results (phase 21: gwas K1, K2 and K7, gwas-mp's
    # ranks K3, K2 and K7), the mesh (phase 22: K1, K2, K7 on its
    # shards) and the resumed gwas-mp (phase 23: K3, K2, K7); K4 runs in
    # phase 2's checks alone
    rows = [("score_topw", TOPW_SOURCE, TOPW_REPLACES,
             mres["k1"] + gw["k1"] + snp["k1"] + ing["k1"] + mesh["k1"],
             e[0], t[0], t[1]),
            ("score_bmax", BMAX_SOURCE, BMAX_REPLACES,
             mres["k2"] + gw["k2"] + snp["k2"] + ing["k2"] + mesh["k2"]
             + crash["k2"], e[1], t[2], t[3]),
            ("score_tilemax", TILEMAX_SOURCE, TILEMAX_REPLACES,
             pres["k3"] + ing["k3"] + crash["k3"], e[2], t[4], t[5]),
            ("score_t", SCORE_T_SOURCE, SCORE_T_REPLACES,
             kres["k4"], e[3], t[6], t[7]),
            ("score_rows", SCORE_ROWS_SOURCE, SCORE_ROWS_REPLACES,
             bres["k5"], e[4], t[8], t[9]),
            ("kinship_gram", KINSHIP_SOURCE, KINSHIP_REPLACES,
             kin["k7"] + gw["k7"] + ing["k7"] + mesh["k7"] + crash["k7"],
             0.0, t[10], t[11]),
            ("kinship_transpose", KINSHIP_SOURCE, KINSHIP_REPLACES,
             kin["k7t"] + gw["k7t"] + ing["k7t"] + mesh["k7t"]
             + crash["k7t"], 0.0, t[12], t[13]),
            ("gen_planes", GEN_SOURCE, GEN_REPLACES, bench_res["k6"], 0.0,
             *gres["times"]),
            ("score_parity", PARITY_SOURCE, PARITY_REPLACES, k8res["k8"],
             k9res["err8"], *k9res["t8"]),
            ("tile_reduce", REDUCE_SOURCE, REDUCE_REPLACES, k9res["k9"][0],
             0.0, k9res["t9"][0], k9res["t9"][1]),
            ("tile_topc", REDUCE_SOURCE, TOPC_REPLACES, k9res["k9"][1], 0.0,
             k9res["t9"][3], k9res["t9"][4])]
    library = {"tile_reduce": k9res["t9"][2], "tile_topc": k9res["t9"][5]}
    idle = [r[0] for r in rows if r[3] <= 0]
    if idle:
        print(f"FAIL: kernels never launched on their path: {idle}",
              file=sys.stderr)
        return 1
    bounds = kernel_bounds(peaks, gen_rows=gres["rows"], gen_w32=gres["w32"],
                           gen_int_floor_ms=env["gen_sass"]["floor_ms"])
    gen_bytes = kernel_bounds(peaks, gen_rows=gres["rows"],
                              gen_w32=gres["w32"])["gen_planes"][0]
    gen_sass_ = env["gen_sass"]
    log(f"K6 bound at ({gres['rows']}, {gres['w32']}): bytes "
        f"{gen_bytes:.4f} ms, integer floor {gen_sass_['floor_ms']:.4f} ms "
        f"from the SASS (set by {gen_sass_['floor_by']}): "
        f"{bounds['gen_planes'][0]:.4f} ms, set by "
        f"{bounds['gen_planes'][1]}")
    log(f"smoke wall {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": [
        {"name": nm, "route": "cuda", "source": src, "replaces": rep,
         "launches": n, "max_abs_err": err, "ms": ms, "plain_ms": pms,
         "bound_ms": bounds[nm][0], "bound_by": bounds[nm][1],
         "library_ms": library.get(nm)}
        for nm, src, rep, n, err, ms, pms in rows]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
