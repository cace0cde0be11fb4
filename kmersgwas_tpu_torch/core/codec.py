"""2-bit k-mer codec, canonization and k-mer-space partitioning.

The port's own copy of kmersgwas_tpu/core/codec.py (the port imports
nothing of the JAX package); the functions and their bits are the same.

Re-implements (TPU-first, vectorized NumPy on host) the semantics of the
reference codec in voichek/kmersGWAS:

  * 2-bit encoding A=0 C=1 G=2 T=3, last base in bits 0..1
    (reference: src/kmer_general.cpp:77-87 `bits2kmer31`,
     src/kmer_general.cpp:260-284 `kmer2bits`)
  * branchless reverse complement (src/kmer_general.h:102-109)
  * canonization = min(kmer, revcomp(kmer))
  * strand flags in the two MSBs of a uint64
    (src/kmers_add_strand_information.cpp:32-38)
  * MurmurHash3 finalizer `Hash64` (src/kmer_general.h:32-41)
  * k-mer-space range partitioning thresholds
    (src/kmer_general.cpp:255-258 `kmers_step_to_threshold`)

All functions operate on numpy uint64 arrays and are the single source of
truth for bit-level semantics across the host ingest pipeline, the native
C++ tools and the device kernels.
"""
from __future__ import annotations

import numpy as np

# Strand flags stored in the two most-significant bits of a 62-bit k-mer word.
FLAG_CANON_ONLY = np.uint64(0x4000000000000000)  # seen only in canonical orientation
FLAG_NON_CANON_ONLY = np.uint64(0x8000000000000000)  # seen only in reverse orientation
FLAG_BOTH = np.uint64(0xC000000000000000)
KMER_MASK_62 = np.uint64(0x3FFFFFFFFFFFFFFF)
NULL_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)

_BASE_TO_CODE = {"A": 0, "C": 1, "G": 2, "T": 3}
_CODE_TO_BASE = np.array(list("ACGT"))
_CODE_TO_ASCII = np.frombuffer(b"ACGT", dtype=np.uint8)

_M32 = np.uint64(0xFFFFFFFF00000000)
_L32 = np.uint64(0x00000000FFFFFFFF)
_M16 = np.uint64(0xFFFF0000FFFF0000)
_L16 = np.uint64(0x0000FFFF0000FFFF)
_M8 = np.uint64(0xFF00FF00FF00FF00)
_L8 = np.uint64(0x00FF00FF00FF00FF)
_M4 = np.uint64(0xF0F0F0F0F0F0F0F0)
_L4 = np.uint64(0x0F0F0F0F0F0F0F0F)
_M2 = np.uint64(0xCCCCCCCCCCCCCCCC)
_L2 = np.uint64(0x3333333333333333)
_M1 = np.uint64(0xAAAAAAAAAAAAAAAA)
_L1 = np.uint64(0x5555555555555555)


def encode_kmers(strings) -> np.ndarray:
    """Encode an iterable of equal-length ACGT strings to uint64 codes."""
    out = np.empty(len(strings), dtype=np.uint64)
    for i, s in enumerate(strings):
        v = 0
        for ch in s:
            v = (v << 2) | _BASE_TO_CODE[ch]
        out[i] = v
    return out


def decode_kmers(codes: np.ndarray, k: int) -> list:
    """Decode uint64 codes back to ACGT strings (reference `bits2kmer31`)."""
    codes = np.asarray(codes, dtype=np.uint64)
    shifts = np.arange(2 * (k - 1), -2, -2, dtype=np.uint64)
    sym = (codes[:, None] >> shifts[None, :]) & np.uint64(3)
    # one bulk byte-buffer decode instead of a Python join per row
    ascii_bytes = _CODE_TO_ASCII[sym.astype(np.int64)]
    flat = ascii_bytes.tobytes().decode("ascii")
    return [flat[i * k:(i + 1) * k] for i in range(len(codes))]


def reverse_complement(x: np.ndarray, k: int) -> np.ndarray:
    """Branchless reverse complement of 2-bit packed k-mers.

    Mirrors src/kmer_general.h:102-109: swap 2-bit groups end-for-end across
    the full 64-bit word, complement, then right-align to 2k bits.
    """
    x = np.asarray(x, dtype=np.uint64)
    x = ((x & _M32) >> np.uint64(32)) | ((x & _L32) << np.uint64(32))
    x = ((x & _M16) >> np.uint64(16)) | ((x & _L16) << np.uint64(16))
    x = ((x & _M8) >> np.uint64(8)) | ((x & _L8) << np.uint64(8))
    x = ((x & _M4) >> np.uint64(4)) | ((x & _L4) << np.uint64(4))
    x = ((x & _M2) >> np.uint64(2)) | ((x & _L2) << np.uint64(2))
    return (~x) >> np.uint64(64 - 2 * k)


def bit_reverse64(x: np.ndarray) -> np.ndarray:
    """Full bitwise reverse of uint64 values (reference `reverseOne`)."""
    x = np.asarray(x, dtype=np.uint64)
    x = ((x & _M32) >> np.uint64(32)) | ((x & _L32) << np.uint64(32))
    x = ((x & _M16) >> np.uint64(16)) | ((x & _L16) << np.uint64(16))
    x = ((x & _M8) >> np.uint64(8)) | ((x & _L8) << np.uint64(8))
    x = ((x & _M4) >> np.uint64(4)) | ((x & _L4) << np.uint64(4))
    x = ((x & _M2) >> np.uint64(2)) | ((x & _L2) << np.uint64(2))
    x = ((x & _M1) >> np.uint64(1)) | ((x & _L1) << np.uint64(1))
    return x


def canonize(x: np.ndarray, k: int) -> np.ndarray:
    """Canonical representation: elementwise min(kmer, revcomp)."""
    rc = reverse_complement(x, k)
    return np.minimum(np.asarray(x, dtype=np.uint64), rc)


def canon_flags(x: np.ndarray, k: int):
    """(canonical_code, strand_flag) for k-mers observed in reads.

    A k-mer that is already its canonical form gets FLAG_CANON_ONLY; one
    observed in the non-canonical orientation maps to its canonical code
    with FLAG_NON_CANON_ONLY (src/kmers_add_strand_information.cpp:32-38).
    """
    x = np.asarray(x, dtype=np.uint64)
    rc = reverse_complement(x, k)
    is_canon = x < rc
    canon = np.where(is_canon, x, rc)
    flags = np.where(is_canon, FLAG_CANON_ONLY, FLAG_NON_CANON_ONLY)
    return canon, flags


def hash64(key: np.ndarray) -> np.ndarray:
    """MurmurHash3 64-bit finalizer (reference `Hash64`, kmer_general.h:32-41)."""
    key = np.asarray(key, dtype=np.uint64).copy()
    key ^= key >> np.uint64(33)
    key *= np.uint64(0xFF51AFD7ED558CCD)
    key ^= key >> np.uint64(33)
    key *= np.uint64(0xC4CEB9FE1A85EC53)
    key ^= key >> np.uint64(33)
    return key


def pattern_hash(words: np.ndarray) -> np.ndarray:
    """Presence/absence pattern hash over packed rows (N_rows, W) uint64.

    Reproduces hash_presence_absence_pattern
    (src/kmers_multiple_databases.cpp:367-374): boost-style hash_combine of
    Hash64 of every word of the row.
    """
    words = np.asarray(words, dtype=np.uint64)
    seed = np.zeros(words.shape[0], dtype=np.uint64)
    magic = np.uint64(0x9E3779B97F4A7C15)
    for w in range(words.shape[1]):
        seed ^= hash64(words[:, w]) + magic + (seed << np.uint64(6)) + (seed >> np.uint64(2))
    return seed


def step_threshold(step: int, total_steps: int, k: int) -> int:
    """Upper k-mer code bound of range-partition slice `step` of `total_steps`.

    Matches kmers_step_to_threshold (src/kmer_general.cpp:255-258) so that
    range-sharded pipelines cut the sorted k-mer space at identical points.
    """
    max_kmer = (1 << (2 * k)) - 1
    return ((max_kmer // total_steps) + 1) * step


def step_bounds(total_steps: int, k: int) -> np.ndarray:
    """All slice upper bounds, shape (total_steps,)."""
    max_kmer = (1 << (2 * k)) - 1
    stride = (max_kmer // total_steps) + 1
    return (np.arange(1, total_steps + 1, dtype=np.uint64)) * np.uint64(stride)
