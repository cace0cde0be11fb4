"""The port's host squeeze library: squeeze + pack of raw .table rows.

`squeeze.cpp` is a copy of kgt_squeeze_pack of
kmersgwas_tpu/native/kgt_ingest.cpp. At first use it is compiled with the
host C++ compiler,

    g++ -std=c++17 -O3 -fPIC -shared -pthread -o build/libkgt_squeeze_<hash>.so
        native/squeeze.cpp

into kmersgwas_tpu_torch/build/ and loaded with ctypes (the ctypes binding
is modelled on kmersgwas_tpu/native/__init__.py). The file name carries a
hash of the source and flags, so an edited source is rebuilt. Nothing is
built at import.

Where no compiler can build it, `available()` is False and the table
reader (core/table.py) takes its numpy squeeze, which writes the same
bytes: this is host code, not a device path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "squeeze.cpp")
BUILD = os.path.join(os.path.dirname(_DIR), "build")
CXX_FLAGS = ("-std=c++17", "-O3", "-fPIC", "-shared", "-pthread")

_U64P = ctypes.POINTER(ctypes.c_ulonglong)


class NativeUnavailable(RuntimeError):
    pass


def _compiler() -> str:
    for name in ("g++", "c++"):
        path = shutil.which(name)
        if path:
            return path
    raise NativeUnavailable("no host C++ compiler (g++ or c++) on PATH")


@functools.cache
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the squeeze library; raises
    NativeUnavailable where it cannot be built."""
    with open(SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode() + src).hexdigest()
    path = os.path.join(BUILD, f"libkgt_squeeze_{digest[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD, exist_ok=True)
        tmp = f"{path}.tmp{os.getpid()}"
        proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeUnavailable(f"squeeze build failed:\n{proc.stderr}")
        os.replace(tmp, path)              # atomic: no half-written .so
    lib = ctypes.CDLL(path)
    lib.kgt_squeeze_pack.restype = ctypes.c_longlong
    lib.kgt_squeeze_pack.argtypes = [
        _U64P, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_ulonglong, _U64P,
        ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_ubyte)]
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def squeeze_pack(raw, file_col, n_used: int, w32: int, min_count: int):
    """Native squeeze+pack of raw table rows (the contract of
    kmersgwas_tpu.native.squeeze_pack).

    raw: (R, 1+wf) uint64; file_col: (n_used,) int64.
    -> (kmers (R,), packed (R, w32) uint32, popcnt (R,) int32, keep (R,) bool)
    """
    lib = load()
    raw = np.ascontiguousarray(raw, dtype=np.uint64)
    file_col = np.ascontiguousarray(file_col, dtype=np.int64)
    if raw.ndim != 2 or file_col.shape != (n_used,):
        raise ValueError(f"raw {raw.shape}, file_col {file_col.shape}, "
                         f"n_used {n_used}")
    if len(file_col) and int(file_col.max()) >= 64 * (raw.shape[1] - 1):
        raise ValueError("file_col points past the row's words")
    r = raw.shape[0]
    wf = raw.shape[1] - 1
    kmers = np.empty(r, dtype=np.uint64)
    packed = np.empty((r, w32), dtype=np.uint32)
    pop = np.empty(r, dtype=np.int32)
    keep = np.empty(r, dtype=np.uint8)
    rc = lib.kgt_squeeze_pack(
        raw.ctypes.data_as(_U64P), r, wf,
        file_col.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        n_used, w32, min_count,
        kmers.ctypes.data_as(_U64P),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint)),
        pop.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        keep.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)))
    if rc < 0:
        raise RuntimeError("kgt_squeeze_pack failed (w32 * 32 < n_used)")
    return kmers, packed, pop, keep.astype(bool)
