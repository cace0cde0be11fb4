"""The port's two host libraries, built at first use and loaded with ctypes.

  * the squeeze (`squeeze.cpp`, a copy of kgt_squeeze_pack of
    kmersgwas_tpu/native/kgt_ingest.cpp): squeeze + pack of raw .table
    rows, for the table reader (core/table.py) and the winner fetch;
  * the ingest (`kgt_ingest.cpp`, a copy of the rest of that file):
    k-mer counting from reads, the strand merge, the union of strand lists
    into the master list and the table build, for the CLI's `count`,
    `strand-merge`, `list-kmers` and `build-table`.

Each is compiled with the host C++ compiler,

    g++ -std=c++17 -O3 -fPIC -shared -pthread -o build/libkgt_<name>_<hash>.so
        native/<source> [-lz]

into kmersgwas_tpu_torch/build/ (the ingest links zlib for gzip reads).
The file name carries a hash of the source and flags, so an edited source
is rebuilt; each build writes a temporary file of its own and renames
it, so processes or threads that build at once never load a
half-written library. Nothing is built at
import. The ctypes bindings are modelled on kmersgwas_tpu/native/__init__.py.

Where a library cannot be built, its `available()` is False: the table
reader takes its numpy squeeze, and the CLI the numpy ingest (ingest/),
which write the same bytes. This is host code either way, not a device
path. The two are built apart, so a host without zlib's header keeps the
native squeeze.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(_DIR, "squeeze.cpp")
INGEST_SOURCE = os.path.join(_DIR, "kgt_ingest.cpp")
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


def _build(name: str, source: str, libs: tuple = ()) -> ctypes.CDLL:
    """Build `source` once per hash of it and the flags, and load it."""
    with open(source, "rb") as f:
        src = f.read()
    flags = " ".join(CXX_FLAGS + libs).encode()
    digest = hashlib.sha256(flags + src).hexdigest()
    path = os.path.join(BUILD, f"libkgt_{name}_{digest[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD, exist_ok=True)
        # a temporary name of this call's own: processes and threads that
        # build at once never write one file
        fd, tmp = tempfile.mkstemp(dir=BUILD, prefix=f"libkgt_{name}_",
                                   suffix=".tmp")
        os.close(fd)
        try:
            proc = subprocess.run([_compiler(), *CXX_FLAGS, "-o", tmp,
                                   source, *libs],
                                  capture_output=True, text=True,
                                  timeout=300)
            if proc.returncode != 0:
                raise NativeUnavailable(
                    f"{name} build failed:\n{proc.stderr}")
            os.replace(tmp, path)          # atomic: no half-written .so
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return ctypes.CDLL(path)


@functools.cache
def load() -> ctypes.CDLL:
    """Build (once per source hash) and load the squeeze library; raises
    NativeUnavailable where it cannot be built."""
    lib = _build("squeeze", SOURCE)
    lib.kgt_squeeze_pack.restype = ctypes.c_longlong
    lib.kgt_squeeze_pack.argtypes = [
        _U64P, ctypes.c_longlong, ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_ulonglong, _U64P,
        ctypes.POINTER(ctypes.c_uint), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_ubyte)]
    return lib


def available() -> bool:
    """Whether the squeeze library builds and loads here."""
    try:
        load()
        return True
    except NativeUnavailable:
        return False


@functools.cache
def load_ingest() -> ctypes.CDLL:
    """Build (once per source hash) and load the ingest library; raises
    NativeUnavailable where it cannot be built (no compiler, or no zlib)."""
    lib = _build("ingest", INGEST_SOURCE, ("-lz",))
    paths = ctypes.POINTER(ctypes.c_char_p)
    lib.kgt_count.restype = ctypes.c_longlong
    lib.kgt_count.argtypes = [paths, ctypes.c_int, ctypes.c_uint,
                              ctypes.c_int, ctypes.c_ulonglong,
                              ctypes.c_char_p, ctypes.c_char_p,
                              ctypes.c_ulonglong]
    lib.kgt_strand_merge.restype = ctypes.c_longlong
    lib.kgt_strand_merge.argtypes = [ctypes.c_char_p, ctypes.c_char_p,
                                     ctypes.c_uint, ctypes.c_char_p]
    lib.kgt_list_union_stats.restype = ctypes.c_longlong
    lib.kgt_list_union_stats.argtypes = [paths, ctypes.c_int, ctypes.c_uint,
                                         ctypes.c_ulonglong, ctypes.c_double,
                                         ctypes.c_char_p, ctypes.c_int]
    lib.kgt_build_table.restype = ctypes.c_longlong
    lib.kgt_build_table.argtypes = [paths, ctypes.c_int, ctypes.c_char_p,
                                    ctypes.c_char_p, ctypes.c_uint]
    return lib


def ingest_available() -> bool:
    """Whether the ingest library builds and loads here."""
    try:
        load_ingest()
        return True
    except NativeUnavailable:
        return False


def _paths_array(paths):
    arr = (ctypes.c_char_p * len(paths))()
    arr[:] = [str(p).encode() for p in paths]
    return arr


def count(paths, k: int, canonize: bool, min_count: int, out_path,
          tmpdir: str | None = None, max_mem_kmers: int = 1 << 27) -> int:
    """Count the k-mers of read files into a sorted (uint64 kmer, uint64
    count) record file -> #distinct k-mers (kgt_count). Buckets that
    outgrow memory spill into `tmpdir`; by default a directory of this
    call's own under the system's temporary directory, so calls running at
    once never share spill files."""
    lib = load_ingest()
    with tempfile.TemporaryDirectory(prefix="kgt_count_",
                                     dir=tmpdir) as spill:
        n = lib.kgt_count(_paths_array(paths), len(paths), k, int(canonize),
                          min_count, str(out_path).encode(), spill.encode(),
                          max_mem_kmers)
    if n < 0:
        raise RuntimeError(f"kgt_count failed ({n})")
    return n


def strand_merge(canon_path, non_canon_path, k: int, out_path) -> int:
    """Canonized + as-read count files -> strand-flagged sorted list
    (kgt_strand_merge) -> #k-mers written."""
    lib = load_ingest()
    n = lib.kgt_strand_merge(str(canon_path).encode(),
                             str(non_canon_path).encode(), k,
                             str(out_path).encode())
    if n == -2:
        raise ValueError("canonized k-mers without orientation evidence "
                         "(non-canonized counts must use min_count=1)")
    if n < 0:
        raise RuntimeError(f"kgt_strand_merge failed ({n})")
    return n


def list_union(paths, k: int, mac: int, min_strand_frac: float, out_path,
               write_stats: bool = False) -> int:
    """N strand lists -> master list (+ the side artifacts with
    write_stats) (kgt_list_union_stats) -> #passing k-mers."""
    lib = load_ingest()
    n = lib.kgt_list_union_stats(_paths_array(paths), len(paths), k, mac,
                                 min_strand_frac, str(out_path).encode(),
                                 1 if write_stats else 0)
    if n < 0:
        raise RuntimeError(f"kgt_list_union failed ({n})")
    return n


def build_table(list_paths, names, master_path, out_base, k: int) -> int:
    """Strand lists + master list -> `<out_base>.table` (kgt_build_table)
    and `<out_base>.names` -> #rows."""
    from ..core import formats
    lib = load_ingest()
    n = lib.kgt_build_table(_paths_array(list_paths), len(list_paths),
                            str(master_path).encode(),
                            (str(out_base) + ".table").encode(), k)
    if n < 0:
        raise RuntimeError(f"kgt_build_table failed ({n})")
    formats.write_names(out_base, names)
    return n


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
