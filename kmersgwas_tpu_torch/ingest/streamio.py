"""Buffered streaming cursors over sorted binary k-mer list files.

The port's own copy of kmersgwas_tpu/ingest/streamio.py (the port imports
nothing of the JAX package); it reads and writes the same bytes.

The reference never holds a whole sample list in memory: it walks k-mer
space in threshold-bounded slices, reading each sorted file forward with
`load_kmers_upto_x` (src/kmers_single_database.cpp:158-177) driven by the
5,000 slice thresholds (src/kmer_general.cpp:255-258). This module is that
primitive for the out-of-core list and table builds: a forward-only
cursor over a sorted uint64 list (optionally strand-flagged in the 2 MSBs)
that returns every remaining element whose low-62-bit code is <= a bound.

Memory is bounded by `chunk_words` per open file regardless of file size.
"""
from __future__ import annotations

import os

import numpy as np

from ..core import codec

_MASK62 = codec.KMER_MASK_62


class SortedListCursor:
    """Forward cursor over a sorted (by low 62 bits) uint64 list file.

    read_upto(bound) -> raw uint64 words (flags intact) for every remaining
    element with (word & MASK62) <= bound, in file order. Subsequent calls
    continue where the previous one stopped; bounds must be nondecreasing.
    """

    def __init__(self, path, chunk_words: int = 1 << 20):
        self.path = str(path)
        self.chunk_words = int(chunk_words)
        self._f = open(self.path, "rb")
        self.n_total = os.path.getsize(self.path) // 8
        self.n_read = 0                      # elements consumed from file
        self._buf = np.empty(0, dtype="<u8")  # read but not yet returned
        self._eof = self.n_total == 0

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    @property
    def exhausted(self) -> bool:
        return self._eof and len(self._buf) == 0

    def _refill(self) -> bool:
        if self._eof:
            return False
        chunk = np.fromfile(self._f, dtype="<u8", count=self.chunk_words)
        if len(chunk) < self.chunk_words:
            self._eof = True
        if len(chunk) == 0:
            return False
        self._buf = np.concatenate([self._buf, chunk]) if len(self._buf) else chunk
        return True

    def read_upto(self, bound: int) -> np.ndarray:
        """All remaining raw words with low-62 code <= bound (file order)."""
        bound = np.uint64(bound)
        out = []
        while True:
            if len(self._buf):
                codes = self._buf & _MASK62
                # sorted by low 62 bits -> first index exceeding the bound
                cut = int(np.searchsorted(codes, bound, side="right"))
                if cut:
                    out.append(self._buf[:cut])
                    self._buf = self._buf[cut:]
                    self.n_read += cut
                if len(self._buf):          # stopped before the buffer end
                    break
            if not self._refill():
                break
        if not out:
            return np.empty(0, dtype="<u8")
        return out[0] if len(out) == 1 else np.concatenate(out)


def auto_slices(paths, target_rows_per_slice: int = 1 << 22,
                max_slices: int = 5000) -> int:
    """Pick a slice count so each slice holds roughly `target_rows_per_slice`
    elements across all inputs (the reference fixes 5,000 slices,
    build_kmers_table.cpp:98; here the count adapts to the data so small
    inputs do not pay 5,000 python iterations)."""
    total = sum(os.path.getsize(str(p)) // 8 for p in paths)
    return max(1, min(max_slices, -(-total // target_rows_per_slice)))
