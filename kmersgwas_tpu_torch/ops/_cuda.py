"""Build and bind the hand-written CUDA kernels of csrc/.

At first use, `library()` compiles every source of csrc/ with nvcc, one
process per source, all started together,

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -Xcompiler
         -fPIC -Xptxas -v -c -o build/<hash>/<source>.o csrc/<source>

links the objects into one shared library with a plain C interface
(`nvcc -shared -o build/libkgt_torch_<hash>.so build/<hash>/*.o`) and
loads it with ctypes. The file name carries a hash of the sources and
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
SOURCES = ("score_topw.cu", "score_plane.cu", "score_tilemax.cu",
           "kinship_gram.cu", "gen_planes.cu", "score_parity.cu",
           "tile_reduce.cu")
HEADERS = ("score_common.cuh", "tile_top3.cuh", "score_topw.cuh",
           "hopper_async.cuh", "score_wgmma.cuh")
NVCC_CANDIDATES = ("/usr/local/cuda/bin/nvcc",)     # looked at after PATH
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

# rows of the score kernels' block tile (csrc/score_common.cuh TILE_ROWS):
# batch rows must be a multiple of it, and the top-3 captures of score_topw
# and score_tilemax are per TILE_ROWS-row tile
TILE_ROWS = 128
# column chunks the tensor-core body (csrc/score_wgmma.cuh) is built for
# (its `dispatch_chunk`): score_topw, score_tilemax, score_parity and
# score_plane (score_bmax, score_t, score_rows) run P columns as chunks of
# one of these widths. The widest is 128, not wgmma's 256: chunks of 192
# and 256 columns need more registers than two blocks an SM leave, and at
# one block an SM they took longer per column than chunks of 128 at two
# (timed on the card).
WGMMA_CHUNKS = (8, 16, 32, 64, 104, 128)
# samples per stage of the tensor-core body's ring (csrc/score_wgmma.cuh KC)
WGMMA_KC = 64

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
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
    digest = _digest()
    path = os.path.join(BUILD, f"libkgt_torch_{digest}.so")
    build_s, log = None, ""
    if not os.path.exists(path):
        objdir = os.path.join(BUILD, f"{digest}.{os.getpid()}")
        os.makedirs(objdir, exist_ok=True)
        t0 = time.perf_counter()
        objs = [os.path.join(objdir, s + ".o") for s in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", o, os.path.join(CSRC, s)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for s, o in zip(SOURCES, objs)]
        outs = [(s, pr.communicate()[0], pr.returncode)
                for s, pr in zip(SOURCES, procs)]
        log = "".join(out for _, out, _ in outs)
        bad = [(s, rc) for s, _, rc in outs if rc != 0]
        if bad:
            raise RuntimeError(f"nvcc failed on {bad}:\n{log}")
        tmp = f"{path}.tmp{os.getpid()}"
        proc = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n"
                               f"{log}")
        os.replace(tmp, path)                 # atomic: no half-written .so
        shutil.rmtree(objdir, ignore_errors=True)
        build_s = time.perf_counter() - t0
    lib = ctypes.CDLL(path)
    lib.kgt_score_topw.restype = _I
    lib.kgt_score_topw.argtypes = [
        _P, _P, _P, _P, _P,            # packed, popcnt, b, ysum, thresh
        _LL, _I, _I,                   # n_rows, w32, p
        _I, _I, _I, _F, _F,            # nc, n_cc, planes, n, min_count
        _I,                            # cand_w
        _P, _P, _P,                    # tile_v, tile_g, tile_cnt
        _P, _P, _P,                    # out_v, out_g, out_ok
        _P,                            # fallbacks
        _P]                            # stream
    lib.kgt_select_path.restype = _I
    lib.kgt_select_path.argtypes = [_I, _I, _I]    # n_tiles, lists, w
    lib.kgt_topw_select.restype = _I
    lib.kgt_topw_select.argtypes = [
        _P, _P, _P,                    # tile_v, tile_g, tile_cnt
        _I, _I, _I, _I,                # n_tiles, p, lists, w
        _P, _P, _P,                    # out_v, out_g, out_ok
        _P,                            # fallbacks
        _P]                            # stream
    for name, outs in (("kgt_score_bmax", [_P, _P]),   # scores, bmax
                       ("kgt_score_t", [_P]),           # scores
                       ("kgt_score_rows", [_P])):       # scores
        fn = getattr(lib, name)
        fn.restype = _I
        fn.argtypes = [
            _P, _P, _P, _P,            # packed, popcnt, b, ysum
            _LL, _I, _I,               # n_rows, w32, p
            _I, _I, _I, _F, _F,        # nc, n_cc, planes, n, min_count
            *outs,
            _P]                        # stream
    lib.kgt_score_tilemax.restype = _I
    lib.kgt_score_tilemax.argtypes = [
        _P, _P, _P, _P, _P,            # packed, popcnt, b, ysum, thresh
        _LL, _I, _I,                   # n_rows, w32, p
        _I, _I, _I, _F, _F,            # nc, n_cc, planes, n, min_count
        _P, _P, _P, _P, _P, _P,        # tmax, targ, tmax2, targ2, tmax3, targ3
        _P, _P, _P,                    # n2, n3, cnt
        _P]                            # stream
    lib.kgt_kinship_transpose.restype = _I
    lib.kgt_kinship_transpose.argtypes = [
        _P, _LL, _I,                   # packed, n_rows, w32
        _P,                            # bits
        _P]                            # stream
    lib.kgt_kinship_gram.restype = _I
    lib.kgt_kinship_gram.argtypes = [
        _P, _LL, _I,                   # bits, n_rows, w32
        _P,                            # acc
        _P]                            # stream
    lib.kgt_gen_planes.restype = _I
    lib.kgt_gen_planes.argtypes = [
        _P, _P, _LL, _I,               # planes, pc, rows, w32
        _ULL, _ULL,                    # seed, step
        _P]                            # stream
    lib.kgt_score_parity.restype = _I
    lib.kgt_score_parity.argtypes = [
        _P, _P, _P, _P, _P,            # packed, popcnt, b, ysum, thresh
        _LL, _I, _I,                   # n_rows, w32, p
        _I, _I, _I, _F, _F,            # nc, n_cc, planes, n, min_count
        _I, _I,                        # tile_rows, w
        _P, _P, _P,                    # tile_v, tile_g, tile_cnt
        _P, _P, _P,                    # mrg_v, mrg_g, mrg_cnt
        _P, _P, _P,                    # out_v, out_g, out_ok
        _P,                            # fallbacks
        _P]                            # stream
    lib.kgt_tile_reduce.restype = _I
    lib.kgt_tile_reduce.argtypes = [
        _P, _P, _I, _I, _I, _I,        # x, th, p, nt, tr, fold_to
        _P, _P, _P, _P, _P, _P, _P,    # m1, a1, a1_fold, m2, a2_sum, n_eq, cnt
        _P]                            # stream
    lib.kgt_tile_topc.restype = _I
    lib.kgt_tile_topc.argtypes = [
        _P, _I, _I,                    # m1, p, nt
        _P, _P,                        # out_v, out_i
        _P]                            # stream
    lib.kgt_error_string.restype = ctypes.c_char_p
    lib.kgt_error_string.argtypes = [_I]
    return KernelLib(lib, path, version, build_s, log)


def check(lib: KernelLib, rc: int, what: str) -> None:
    if rc != 0:
        msg = lib.lib.kgt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")
