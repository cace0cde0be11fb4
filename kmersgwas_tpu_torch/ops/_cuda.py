"""Build and bind the hand-written CUDA kernels of csrc/.

At first use, `library()` compiles every source of csrc/ with nvcc into one
shared library with a plain C interface,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/libkgt_torch_<hash>.so csrc/*.cu

and loads it with ctypes. The file name carries a hash of the sources and
flags, so an edited source is rebuilt and a stale library is never loaded.
Nothing is built or loaded at import: the CPU tests import this module on
machines without nvcc.

Every C entry point launches on the stream it is given, allocates nothing
and returns cudaGetLastError(); `check` raises on a non-zero code. There is
no fallback: a build or launch error is an exception.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
SOURCES = ("score_topw.cu", "score_bmax.cu")
HEADERS = ("score_common.cuh",)
NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)     # looked at after PATH
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# block tile of the kernels (csrc/score_common.cuh TILE_ROWS / TILE_COLS):
# batch rows must be a multiple of TILE_ROWS, and the top-3 capture of
# score_topw is per TILE_ROWS-row tile
TILE_ROWS = 128
TILE_COLS = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


@dataclass(frozen=True)
class KernelLib:
    lib: ctypes.CDLL
    path: str
    nvcc_version: str
    build_seconds: float | None     # None: an existing build was loaded
    log: str                        # nvcc/ptxas output of this build


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), *NVCC_CANDIDATES):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH or /usr/local/cuda/bin): the "
                       "CUDA kernels cannot be built")


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


@functools.cache
def library() -> KernelLib:
    """Build (once per source hash) and load the kernel library."""
    nvcc = nvcc_path()
    version = subprocess.run([nvcc, "--version"], capture_output=True,
                             text=True, check=True).stdout.strip()
    version = version.splitlines()[-1] if version else "unknown"
    path = os.path.join(BUILD, f"libkgt_torch_{_digest()}.so")
    build_s, log = None, ""
    if not os.path.exists(path):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp,
             *(os.path.join(CSRC, s) for s in SOURCES)],
            capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
        os.replace(tmp, path)                 # atomic: no half-written .so
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    lib.kgt_score_topw.restype = _I
    lib.kgt_score_topw.argtypes = [
        _P, _P, _P, _P, _P,            # packed, popcnt, y, ysum, thresh
        _LL, _I, _I, _I, _F, _F,       # n_rows, w32, p, p_pad, n, min_count
        _I, _I,                        # cand_w, sort_cap
        _P, _P, _P,                    # tile_v, tile_g, tile_cnt
        _P, _P, _P,                    # out_v, out_g, out_ok
        _P]                            # stream
    lib.kgt_score_bmax.restype = _I
    lib.kgt_score_bmax.argtypes = [
        _P, _P, _P, _P,                # packed, popcnt, y, ysum
        _LL, _I, _I, _I, _F, _F,       # n_rows, w32, p, p_pad, n, min_count
        _P, _P,                        # scores, bmax
        _P]                            # stream
    lib.kgt_error_string.restype = ctypes.c_char_p
    lib.kgt_error_string.argtypes = [_I]
    return KernelLib(lib, path, version, build_s, log)


def check(lib: KernelLib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lib.kgt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
