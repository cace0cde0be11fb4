"""The benchmark's traffic generator: random packed bit-planes and their
popcounts, a frozen copy of the port's K6.

`gen_planes.cu` beside this file is kmersgwas_tpu_torch/csrc/gen_planes.cu
as it stood at commit 6d84111, and `gen_planes_plain` is a copy of
kmersgwas_tpu_torch/ops/gen.py `gen_planes_plain` of the same commit. The
copy keeps the benchmark's rows fixed while the port's kernel changes: a
later change to K6 cannot change the traffic.

Word j of row r of batch `step` is component j % 4 of
Philox4x32-10(counter = (r, j // 4, step mod 2^32, step >> 32),
key = (seed mod 2^32, seed >> 32)); a row's popcount counts all W32 words,
padding lanes included. Rows are (R, W32) int32 (the int32 view of the
uint32 words, LSB-first).

The kernel is built at first use with nvcc into a shared library with a
plain C interface under benchmark/build/, named by a hash of its source and
flags, and loaded with ctypes. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(HERE, "gen_planes.cu")
BUILD = os.path.join(os.path.dirname(HERE), "build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for a 32-bit constant m and int64 x
    in [0, 2^32), with m split into 16-bit halves so no product overflows."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter (c0, c1, c2, c3), int64 tensors holding
    32-bit values, under the key (k0, k1)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _MASK32
        k1 = (k1 + PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def popcount_rows(planes: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of (R, W32) int32 planes -> (R,) float32."""
    v = planes.to(torch.int64) & _MASK32
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & _MASK32) >> 24
    return v.sum(dim=-1).to(torch.float32)


def _check(w32: int, seed: int) -> None:
    if w32 <= 0 or w32 % 4:
        raise ValueError(f"w32 ({w32}) must be a positive multiple of 4")
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed ({seed}) must be in [0, 2^64)")


def gen_planes_plain(row_ids: torch.Tensor, w32: int, seed: int, step, *,
                     popcount: bool = True):
    """Rows `row_ids` ((n,) integers in [0, 2^32)) of batch `step` (an int,
    or an (n,) int64 tensor giving each row's batch) under `seed`, in torch
    int64 arithmetic on row_ids' device -> ((n, W32) int32 planes, (n,) f32
    popcounts), or the planes alone when popcount is False."""
    _check(w32, seed)
    r = row_ids.to(torch.int64)
    nb = w32 // 4
    shape = (r.shape[0], nb)
    if isinstance(step, int):
        s_lo, s_hi = step & _MASK32, step >> 32
    else:
        step = step.to(device=r.device, dtype=torch.int64)
        s_lo, s_hi = step & _MASK32, step >> 32
    c0 = r[:, None].expand(shape)
    c1 = torch.arange(nb, dtype=torch.int64, device=r.device)[None, :] \
        .expand(shape)
    c2, c3 = (torch.as_tensor(s, dtype=torch.int64, device=r.device)
              .reshape(-1, 1).expand(shape) for s in (s_lo, s_hi))
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, seed & _MASK32,
                                      seed >> 32), dim=-1).reshape(-1, w32)
    planes = torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                         words).to(torch.int32)
    return (planes, popcount_rows(planes)) if popcount else planes


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the generator cannot be built")


@functools.cache
def library() -> ctypes.CDLL:
    """Build (once per source hash, into benchmark/build/) and load the
    generator."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    path = os.path.join(BUILD, f"libbench_gen_{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    lib.bench_gen_planes.restype = ctypes.c_int
    lib.bench_gen_planes.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_ulonglong, ctypes.c_ulonglong, ctypes.c_void_p]
    return lib


def gen_planes(rows: int, w32: int, seed: int, step: int, device, *,
               popcount: bool = True):
    """Batch `step` under `seed`: ((rows, W32) int32 planes, (rows,) f32
    popcounts) on `device`, or the planes alone when popcount is False. A
    CUDA device launches the kernel on the current stream; the CPU takes
    gen_planes_plain."""
    _check(w32, seed)
    if not 0 < rows <= 1 << 32 or not 0 <= step < 1 << 64:
        raise ValueError(f"rows ({rows}) or step ({step}) out of range")
    dev = torch.device(device)
    if dev.type == "cpu":
        return gen_planes_plain(torch.arange(rows), w32, seed, step,
                                popcount=popcount)
    planes = torch.empty((rows, w32), dtype=torch.int32, device=dev)
    pc = torch.empty(rows, dtype=torch.float32, device=dev) \
        if popcount else None
    with torch.autograd.profiler.record_function("bench::gen"):
        rc = library().bench_gen_planes(
            planes.data_ptr(), pc.data_ptr() if popcount else None, rows,
            w32, seed, step, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"bench_gen_planes: CUDA error {rc}")
    return (planes, pc) if popcount else planes
