"""The k-mers table format of voichek/kmersGWAS, written and read without
the port (src/kmers_merge_multiple_databaes.cpp:54-73, :106-119).

`<base>.table`: a header of uint32 magic 0xDDCCBBAA, uint64 number of
accessions, uint32 k-mer length, then one row per k-mer: its uint64 code
and ceil(n / 64) uint64 presence words, bit b of word w for accession
64 w + b (LSB-first). All little-endian. `<base>.names`: the accession
names, one a line.
"""
from __future__ import annotations

import struct

import numpy as np

MAGIC = 0xDDCCBBAA
HEADER = struct.Struct("<IQI")


def row_words(n_accessions: int) -> int:
    return (n_accessions + 63) // 64


class TableWriter:
    """Append rows to a new `<base>.table` and write `<base>.names`."""

    def __init__(self, base: str, names, kmer_len: int):
        self.n = len(names)
        self.f = open(base + ".table", "wb")
        self.f.write(HEADER.pack(MAGIC, self.n, kmer_len))
        with open(base + ".names", "w") as nf:
            nf.write("".join(f"{nm}\n" for nm in names))

    def append(self, codes: np.ndarray, words: np.ndarray) -> None:
        rows = np.empty((len(codes), 1 + row_words(self.n)), "<u8")
        rows[:, 0] = codes
        rows[:, 1:] = words
        rows.tofile(self.f)

    def close(self) -> None:
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_table(base: str):
    """-> (n_accessions, kmer_len, (R, 1 + W) uint64 memmap of the rows:
    the code in column 0, the presence words after it)."""
    with open(base + ".table", "rb") as f:
        magic, n, klen = HEADER.unpack(f.read(HEADER.size))
    if magic != MAGIC:
        raise ValueError(f"{base}.table: bad magic {magic:#x}")
    rows = np.memmap(base + ".table", dtype="<u8", mode="r",
                     offset=HEADER.size).reshape(-1, 1 + row_words(n))
    return n, klen, rows
