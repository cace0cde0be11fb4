"""Bit-exact binary/text file formats shared with voichek/kmersGWAS.

The port's own copy of kmersgwas_tpu/core/formats.py (the port imports
nothing of the JAX package); it reads and writes the same bytes.

Every artifact the reference pipeline persists is readable/writable here:

  * sorted per-sample strand-flagged k-mer lists
    (src/kmers_add_strand_information.cpp:137-145,
     src/kmers_single_database.cpp:144-177)
  * the filtered master k-mer list (src/list_kmers_found_in_multiple_samples.cpp:190)
  * the k-mers table `.table` + `.names`
    (src/kmers_merge_multiple_databaes.cpp:54-73)
  * phenotype TSVs (src/kmer_general.cpp:175-205) and `.fam` files
    (src/kmer_general.cpp:207-225)
  * PLINK .bed/.bim export (src/kmers_multiple_databases.cpp:204-252)
  * binary best-k-mer dumps (src/best_associations_heap.cpp:67-92)

All multi-byte integers are little-endian, as written by the reference on
x86. NumPy-vectorized so host-side ingest stays fast without native code.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from . import codec

TABLE_MAGIC = 0xDDCCBBAA  # uint32 LE view of bytes AA BB CC DD
PLINK_BED_MAGIC = bytes([0x6C, 0x1B, 0x01])


# ---------------------------------------------------------------------------
# Sorted k-mer lists (with or without strand flags in the 2 MSBs)
# ---------------------------------------------------------------------------

def write_kmer_list(path, kmers: np.ndarray) -> None:
    """Write raw uint64 k-mer codes (flags may be embedded in the 2 MSBs)."""
    np.asarray(kmers, dtype="<u8").tofile(str(path))


def read_kmer_list(path) -> np.ndarray:
    return np.fromfile(str(path), dtype="<u8")


def read_kmer_list_split_flags(path):
    """Read a strand-flagged list -> (kmers_62bit, flags in {1,2,3}).

    Mirrors KmersSingleDataBaseSortedFile::read_kmer
    (src/kmers_single_database.cpp:144-150): flag = word >> 62, kmer = low 62.
    """
    raw = read_kmer_list(path)
    return raw & codec.KMER_MASK_62, (raw >> np.uint64(62)).astype(np.uint8)


def write_strand_kmer_list(path, kmers62: np.ndarray, flags: np.ndarray) -> None:
    """Write k-mers with 2-bit strand flags, sorted by the low 62 bits
    (src/kmers_add_strand_information.cpp:137-144)."""
    kmers62 = np.asarray(kmers62, dtype=np.uint64)
    flags = np.asarray(flags, dtype=np.uint64)
    words = kmers62 | (flags << np.uint64(62))
    order = np.argsort(kmers62, kind="stable")
    write_kmer_list(path, words[order])


# ---------------------------------------------------------------------------
# k-mers table (.table / .names)
# ---------------------------------------------------------------------------

@dataclass
class TableHeader:
    n_accessions: int
    kmer_len: int

    HEADER_BYTES = 4 + 8 + 4

    def row_words(self) -> int:
        """uint64 presence/absence words per row (excluding the k-mer word)."""
        return (self.n_accessions + 63) // 64

    def row_bytes(self) -> int:
        return 8 * (1 + self.row_words())


def write_table_header(f, n_accessions: int, kmer_len: int) -> None:
    f.write(struct.pack("<IQI", TABLE_MAGIC, n_accessions, kmer_len))


def read_table_header(f) -> TableHeader:
    magic, n_acc, klen = struct.unpack("<IQI", f.read(TableHeader.HEADER_BYTES))
    if magic != TABLE_MAGIC:
        raise ValueError(f"bad k-mers table magic: {magic:#x}")
    return TableHeader(n_accessions=n_acc, kmer_len=klen)


def write_table_rows(f, kmers: np.ndarray, pa_words: np.ndarray) -> None:
    """Append rows: uint64 k-mer followed by its presence/absence words.

    `pa_words` has shape (n_kmers, row_words); bit b of word w = accession
    w*64+b (LSB-first), matching kmers_merge_multiple_databaes.cpp:106-119.
    """
    kmers = np.asarray(kmers, dtype="<u8")
    pa_words = np.asarray(pa_words, dtype="<u8")
    rows = np.concatenate([kmers[:, None], pa_words], axis=1)
    rows.tofile(f)


def read_table(path_base: str):
    """Read an entire .table -> (header, kmers, pa_words). For tests/small data."""
    with open(str(path_base) + ".table", "rb") as f:
        hdr = read_table_header(f)
        body = np.fromfile(f, dtype="<u8")
    w = hdr.row_words()
    rows = body.reshape(-1, 1 + w)
    return hdr, rows[:, 0].copy(), rows[:, 1:].copy()


def write_names(path_base: str, names) -> None:
    with open(str(path_base) + ".names", "w") as f:
        for n in names:
            f.write(f"{n}\n")


def read_names(path_base: str) -> list:
    """Accession (column) names of a k-mers table (src/kmer_general.cpp:45-53).

    The reference reads whitespace-delimited tokens; we split on any
    whitespace for byte-compatibility."""
    with open(str(path_base) + ".names") as f:
        return f.read().split()


# ---------------------------------------------------------------------------
# Phenotypes (TSV with header accession_id<TAB>pheno1[<TAB>pheno2...])
# ---------------------------------------------------------------------------

@dataclass
class PhenotypeTable:
    names: list          # phenotype column names
    accessions: list     # accession ids (row order)
    values: np.ndarray   # (n_accessions, n_phenotypes) float64

    @property
    def n(self) -> int:
        return len(self.accessions)


def read_phenotypes(path) -> PhenotypeTable:
    """Parse the multi-column phenotype TSV (src/kmer_general.cpp:175-205)."""
    with open(str(path)) as f:
        lines = [ln.rstrip("\n") for ln in f if ln.strip() != ""]
    header = lines[0].split("\t")
    names = header[1:]
    accessions, rows = [], []
    for ln in lines[1:]:
        tok = ln.split("\t")
        if len(tok) != len(names) + 1:
            raise ValueError(f"phenotype row has {len(tok)} fields, expected {len(names) + 1}")
        accessions.append(tok[0])
        rows.append([float(x) for x in tok[1:]])
    return PhenotypeTable(names=names, accessions=accessions,
                          values=np.asarray(rows, dtype=np.float64))


def write_phenotypes(path, table: PhenotypeTable, fmt="%g") -> None:
    with open(str(path), "w") as f:
        f.write("accession_id\t" + "\t".join(table.names) + "\n")
        for i, acc in enumerate(table.accessions):
            vals = "\t".join(fmt % v for v in table.values[i])
            f.write(f"{acc}\t{vals}\n")


def write_fam(path, accessions, values: np.ndarray) -> None:
    """PLINK .fam with phenotype column(s) (src/kmer_general.cpp:207-225)."""
    values = np.atleast_2d(np.asarray(values, dtype=np.float64))
    if values.shape[0] != len(accessions):
        values = values.T
    with open(str(path), "w") as f:
        for i, acc in enumerate(accessions):
            cols = " ".join("%g" % v for v in values[i])
            f.write(f"{acc} {acc} 0 0 0 {cols}\n")


def read_fam_names(path) -> list:
    names = []
    with open(str(path)) as f:
        for line in f:
            tok = line.split()
            if tok:
                names.append(tok[0])
    return names


# ---------------------------------------------------------------------------
# PLINK .bed / .bim presence-absence export
# ---------------------------------------------------------------------------

def pa_words_to_bed_bytes(pa_words: np.ndarray, n_accessions: int) -> np.ndarray:
    """Packed PA rows (R, W) uint64 -> PLINK bed genotype bytes (R, ceil(N/4)).

    Presence -> 0b11 (homozygous second allele), absence -> 0b00, matching
    write_PA (src/kmers_multiple_databases.cpp:218-239).
    """
    pa_words = np.asarray(pa_words, dtype=np.uint64)
    n_rows = pa_words.shape[0]
    # bits (R, W*64) LSB-first within each word
    shifts = np.arange(64, dtype=np.uint64)
    bits = ((pa_words[:, :, None] >> shifts[None, None, :]) & np.uint64(1)).astype(np.uint8)
    bits = bits.reshape(n_rows, -1)[:, : 4 * ((n_accessions + 3) // 4)]
    quads = bits.reshape(n_rows, -1, 4)
    dubits = quads * np.uint8(3)  # 1 -> 0b11, 0 -> 0b00
    byte = (dubits[:, :, 0]
            | (dubits[:, :, 1] << 2)
            | (dubits[:, :, 2] << 4)
            | (dubits[:, :, 3] << 6)).astype(np.uint8)
    return byte


class BedBimWriter:
    """Streaming PLINK .bed/.bim writer (BedBimFilesHandle equivalent,
    src/kmer_general.h:134-145)."""

    def __init__(self, base_name: str):
        self.f_bed = open(base_name + ".bed", "wb")
        self.f_bim = open(base_name + ".bim", "w")
        self.f_bed.write(PLINK_BED_MAGIC)

    def write_variants(self, names, pa_words: np.ndarray, n_accessions: int) -> None:
        if len(names) == 0:
            return
        for name in names:
            self.f_bim.write(f"0\t{name}\t0\t0\t0\t1\n")
        pa_words_to_bed_bytes(pa_words, n_accessions).tofile(self.f_bed)

    def close(self) -> None:
        self.f_bed.close()
        self.f_bim.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_bed(base_name: str):
    """Read a PLINK bed as a (n_snps, n_samples) uint8 dubit matrix."""
    names = read_fam_names(base_name + ".fam")
    n = len(names)
    bpr = (n + 3) // 4
    with open(base_name + ".bed", "rb") as f:
        magic = f.read(3)
        if magic != PLINK_BED_MAGIC:
            raise ValueError("bad PLINK bed magic")
        body = np.fromfile(f, dtype=np.uint8)
    rows = body.reshape(-1, bpr)
    shifts = np.arange(4, dtype=np.uint8) * 2
    dubits = (rows[:, :, None] >> shifts[None, None, :]) & np.uint8(3)
    return names, dubits.reshape(rows.shape[0], -1)[:, :n]


def read_bed_header(base_name: str):
    """(fam sample names, number of SNPs) of a PLINK bed, from its magic
    and size: nothing of the genotype body is read."""
    names = read_fam_names(base_name + ".fam")
    bpr = (len(names) + 3) // 4
    with open(base_name + ".bed", "rb") as f:
        if f.read(3) != PLINK_BED_MAGIC:
            raise ValueError("bad PLINK bed magic")
        body = f.seek(0, 2) - 3
    if bpr == 0 or body % bpr:
        raise ValueError(f"bed body of {body} bytes is not a whole number "
                         f"of {bpr}-byte SNP rows")
    return names, body // bpr


def iter_bed_rows(base_name: str, chunk: int):
    """Yield (start, rows) over a PLINK bed, rows the (c <= chunk,
    ceil(n/4)) uint8 genotype bytes of SNPs start:start+c (sample j in
    bits 2(j%4)..2(j%4)+1 of byte j//4, as read_bed decodes them). Only one
    chunk is held at a time."""
    names, m = read_bed_header(base_name)
    bpr = (len(names) + 3) // 4
    with open(base_name + ".bed", "rb") as f:
        f.seek(len(PLINK_BED_MAGIC))
        for start in range(0, m, chunk):
            c = min(chunk, m - start)
            yield start, np.fromfile(f, dtype=np.uint8,
                                     count=c * bpr).reshape(c, bpr)


# ---------------------------------------------------------------------------
# Best-associations dumps (src/best_associations_heap.cpp:67-92)
# ---------------------------------------------------------------------------

def write_best_kmers_scores(path, kmers: np.ndarray, scores: np.ndarray) -> None:
    """Binary (uint64 kmer, float64 score) pairs in ascending-score order,
    matching the heap's pop order."""
    order = np.argsort(scores, kind="stable")
    rec = np.empty(len(kmers), dtype=[("k", "<u8"), ("s", "<f8")])
    rec["k"] = np.asarray(kmers, dtype=np.uint64)[order]
    rec["s"] = np.asarray(scores, dtype=np.float64)[order]
    rec.tofile(str(path))


def read_best_kmers_scores(path):
    rec = np.fromfile(str(path), dtype=[("k", "<u8"), ("s", "<f8")])
    return rec["k"].copy(), rec["s"].copy()
