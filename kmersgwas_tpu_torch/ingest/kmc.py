"""KMC k-mer database (.kmc_pre/.kmc_suf) import/export, versions 1 and 2/3.

The port's own copy of kmersgwas_tpu/ingest/kmc.py (the port imports
nothing of the JAX package); it reads and writes the same bytes.

The reference consumes databases produced by the external KMC 3 counter
through its C++ API (SURVEY.md §2.4; the binary and API submodule are absent
from the checkout — the reference's `src/kmers_add_strand_information.cpp:72-85`
is the OpenForListing consumer). This module reads and writes both on-disk
layouts so existing KMC databases can be imported into this framework's
count-file format (and ours exported for KMC-based tooling):

  KMC1 (kmc_version 0):
  .kmc_pre: 'KMCP' | prefix index: (4^lut_prefix_len + 1) uint64 record
            offsets | header | kmc_version u32 | header_size u32 | 'KMCP'
      header: kmer_length u32, mode u32, counter_size u32,
            lut_prefix_length u32, min_count u32, max_count u32,
            total_kmers u64, both_strands u8, pad[3]

  KMC2/3 (kmc_version 0x200, the format KMC >= 2.0 writes):
  .kmc_pre: 'KMCP' | LUT: no_of_bins x 4^lut_prefix_len uint64 record
            offsets + 1 guard | signature_map: (4^signature_len + 1) uint32
            signature -> bin id | header | kmc_version u32 |
            header_size u32 | 'KMCP'
      header: kmer_length u32, mode u32, counter_size u32,
            lut_prefix_length u32, signature_len u32, min_count u32,
            max_count u32, total_kmers u64, both_strands u8, pad[3]
      Records are grouped into signature bins; within the concatenated LUT,
      entry (bin * 4^lut_prefix_len + prefix) holds the first record index
      of that (bin, prefix) cell, so listing reconstructs the k-mer prefix
      as (lut_index % 4^lut_prefix_len) — per-bin record runs are sorted by
      (prefix, suffix). The signature map serves random access only; the
      listing path (all this pipeline needs) never computes signatures.

  .kmc_suf (both versions): 'KMCS' | records | 'KMCS'
      record: ceil((k - lut_prefix_len)/4) suffix bytes (4 symbols/byte,
            first symbol in the top 2 bits) + counter_size LE counter bytes

STATUS: implemented from the published KMC format description and
round-trip tested against itself for both versions across the parameter
grid counter_size 1-4 x lut_prefix_len extremes x k in {15,21,25,31} x
both_strands x both on-disk versions, plus forward compatibility with
header_size larger than the known struct (tests/test_torch_ingest.py holds
the port's copy to the JAX package's). Byte-level compatibility with real
KMC 3 output is unvalidated: no database written by a KMC binary has been
read. Treat `read_kmc` failures on external files as a format-version
problem and report them.
"""
from __future__ import annotations

import struct

import numpy as np

PRE_MARKER = b"KMCP"
SUF_MARKER = b"KMCS"
_HDR1 = struct.Struct("<6IQB3x")   # KMC1 header
_HDR2 = struct.Struct("<7IQB3x")   # KMC2/3 header (adds signature_len)
KMC2_VERSION = 0x200


def write_kmc1(path_base: str, kmers: np.ndarray, counts: np.ndarray, k: int,
               lut_prefix_len: int | None = None, counter_size: int = 4,
               min_count: int = 1, max_count: int = (1 << 32) - 1,
               both_strands: bool = True) -> None:
    """Write a KMC1-format database from sorted k-mer codes + counts."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    counts = np.asarray(counts, dtype=np.uint64)
    if np.any(np.diff(kmers.astype(np.int64)) < 0):
        order = np.argsort(kmers)
        kmers, counts = kmers[order], counts[order]
    if lut_prefix_len is None:
        # KMC heuristic: prefix table ~ a few MB; keep small for tests
        lut_prefix_len = max(1, min(12, k - 1, int(np.log2(len(kmers) + 2) // 2)))
    n_pref = 1 << (2 * lut_prefix_len)
    suf_sym = k - lut_prefix_len
    suf_bytes = (suf_sym + 3) // 4

    prefix = (kmers >> np.uint64(2 * suf_sym)).astype(np.int64)
    # prefix index: first record of each prefix, +guard
    idx = np.searchsorted(prefix, np.arange(n_pref + 1), side="left").astype("<u8")

    with open(path_base + ".kmc_pre", "wb") as f:
        f.write(PRE_MARKER)
        idx.tofile(f)
        hdr = _HDR1.pack(k, 0, counter_size, lut_prefix_len,
                         min_count, min(max_count, (1 << 32) - 1),
                         len(kmers), 1 if both_strands else 0)
        f.write(hdr)
        f.write(struct.pack("<II", 0, len(hdr)))   # kmc_version=0 (KMC1)
        f.write(PRE_MARKER)

    with open(path_base + ".kmc_suf", "wb") as f:
        f.write(SUF_MARKER)
        _pack_suffix_records(kmers, counts, suf_sym, suf_bytes,
                             counter_size).tofile(f)
        f.write(SUF_MARKER)


def minimizer_signature(kmers: np.ndarray, k: int, sig_len: int) -> np.ndarray:
    """Per-k-mer signature: the lexicographically smallest `sig_len`-mer
    window of the 2-bit code (a simplified minimizer — KMC2's signature adds
    canonical/allowed-pattern rules, which only affect WHICH bin a k-mer
    lands in, not the listing semantics this importer relies on)."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    mask = np.uint64((1 << (2 * sig_len)) - 1)
    best = np.full(len(kmers), np.uint64(~np.uint64(0)))
    for off in range(k - sig_len + 1):
        win = (kmers >> np.uint64(2 * off)) & mask
        best = np.minimum(best, win)
    return best


def write_kmc2(path_base: str, kmers: np.ndarray, counts: np.ndarray, k: int,
               lut_prefix_len: int | None = None, signature_len: int = 7,
               n_bins: int = 64, counter_size: int = 4, min_count: int = 1,
               max_count: int = (1 << 32) - 1, both_strands: bool = True
               ) -> None:
    """Write a KMC2/3-format (kmc_version 0x200) database: k-mers grouped
    into signature bins, per-(bin, prefix) LUT + signature map."""
    kmers = np.asarray(kmers, dtype=np.uint64)
    counts = np.asarray(counts, dtype=np.uint64)
    if signature_len >= k:
        signature_len = k - 1
    if lut_prefix_len is None:
        lut_prefix_len = max(1, min(12, k - 1,
                                    int(np.log2(len(kmers) + 2) // 2)))
    n_pref = 1 << (2 * lut_prefix_len)
    n_sig = 1 << (2 * signature_len)
    suf_sym = k - lut_prefix_len
    suf_bytes = (suf_sym + 3) // 4

    sig = minimizer_signature(kmers, k, signature_len)
    sig_map = (np.arange(n_sig, dtype=np.uint64) % n_bins).astype("<u4")
    bins = sig_map[sig.astype(np.int64)].astype(np.uint64)
    # records ordered by (bin, kmer) — within a bin, (prefix, suffix) order
    order = np.lexsort((kmers, bins))
    kmers, counts, bins = kmers[order], counts[order], bins[order]

    prefix = (kmers >> np.uint64(2 * suf_sym)).astype(np.uint64)
    cell = bins * np.uint64(n_pref) + prefix
    # LUT: first record index per (bin, prefix) cell + guard
    lut = np.searchsorted(cell, np.arange(n_bins * n_pref + 1,
                                          dtype=np.uint64)).astype("<u8")

    with open(path_base + ".kmc_pre", "wb") as f:
        f.write(PRE_MARKER)
        lut.tofile(f)
        np.concatenate([sig_map, sig_map[-1:]]).astype("<u4").tofile(f)
        hdr = _HDR2.pack(k, 0, counter_size, lut_prefix_len, signature_len,
                         min_count, min(max_count, (1 << 32) - 1),
                         len(kmers), 1 if both_strands else 0)
        f.write(hdr)
        f.write(struct.pack("<II", KMC2_VERSION, len(hdr)))
        f.write(PRE_MARKER)

    with open(path_base + ".kmc_suf", "wb") as f:
        f.write(SUF_MARKER)
        _pack_suffix_records(kmers, counts, suf_sym, suf_bytes,
                             counter_size).tofile(f)
        f.write(SUF_MARKER)


def _pack_suffix_records(kmers, counts, suf_sym, suf_bytes, counter_size):
    """Suffix symbols packed 4/byte (first symbol in the top 2 bits) +
    little-endian counter bytes."""
    suf_mask = np.uint64((1 << (2 * suf_sym)) - 1) if suf_sym else np.uint64(0)
    suffix = kmers & suf_mask
    rec = np.zeros((len(kmers), suf_bytes + counter_size), dtype=np.uint8)
    for b in range(suf_bytes):
        byte = np.zeros(len(kmers), dtype=np.uint64)
        for s in range(4):
            sym_i = 4 * b + s
            if sym_i >= suf_sym:
                break
            shift = np.uint64(2 * (suf_sym - 1 - sym_i))
            byte |= ((suffix >> shift) & np.uint64(3)) << np.uint64(6 - 2 * s)
        rec[:, b] = byte.astype(np.uint8)
    for c in range(counter_size):
        rec[:, suf_bytes + c] = ((counts >> np.uint64(8 * c))
                                 & np.uint64(0xFF)).astype(np.uint8)
    return rec


def _decode_suffix_records(rec, suf_sym, suf_bytes, counter_size):
    n = rec.shape[0]
    suffix = np.zeros(n, dtype=np.uint64)
    for b in range(suf_bytes):
        byte = rec[:, b].astype(np.uint64)
        for s in range(4):
            sym_i = 4 * b + s
            if sym_i >= suf_sym:
                break
            sym = (byte >> np.uint64(6 - 2 * s)) & np.uint64(3)
            suffix |= sym << np.uint64(2 * (suf_sym - 1 - sym_i))
    counts = np.zeros(n, dtype=np.uint64)
    for c in range(counter_size):
        counts |= rec[:, suf_bytes + c].astype(np.uint64) << np.uint64(8 * c)
    return suffix, counts


def read_kmc(path_base: str):
    """Read a KMC database (version 1 or 2/3) -> (sorted kmer codes uint64,
    counts uint64, k)."""
    with open(path_base + ".kmc_pre", "rb") as f:
        data = f.read()
    if data[:4] != PRE_MARKER or data[-4:] != PRE_MARKER:
        raise ValueError("not a KMC prefix file (bad markers)")
    kmc_version, header_size = struct.unpack("<II", data[-12:-4])
    hdr = data[-12 - header_size:-12]
    if kmc_version == 0:
        (k, mode, counter_size, lut_prefix_len, min_count, max_count,
         total_kmers, both_strands) = _HDR1.unpack(hdr[:_HDR1.size])
        signature_len = None
    elif kmc_version == KMC2_VERSION:
        (k, mode, counter_size, lut_prefix_len, signature_len, min_count,
         max_count, total_kmers, both_strands) = _HDR2.unpack(hdr[:_HDR2.size])
    else:
        raise NotImplementedError(
            f"KMC database version {kmc_version:#x} not supported")

    n_pref = 1 << (2 * lut_prefix_len)
    suf_sym = k - lut_prefix_len
    suf_bytes = (suf_sym + 3) // 4
    rec_bytes = suf_bytes + counter_size

    if kmc_version == 0:
        idx = np.frombuffer(data, dtype="<u8", count=n_pref + 1, offset=4)
        if idx[-1] != total_kmers:
            raise ValueError("prefix index does not cover all records")
        counts_per_cell = np.diff(idx.astype(np.int64))
        prefixes = np.repeat(np.arange(n_pref, dtype=np.uint64),
                             counts_per_cell)
    else:
        # LUT length is whatever sits between the leading marker and the
        # signature map: bins x 4^lut_prefix_len entries + 1 guard
        n_sig = 1 << (2 * signature_len)
        sig_map_bytes = 4 * (n_sig + 1)
        # layout: marker | LUT | sig_map | header | version u32 |
        # header_size u32 | marker
        lut_bytes = len(data) - 4 - sig_map_bytes - header_size - 8 - 4
        n_lut = lut_bytes // 8
        if (n_lut - 1) % n_pref:
            raise ValueError("KMC2 LUT size inconsistent with prefix length")
        idx = np.frombuffer(data, dtype="<u8", count=n_lut, offset=4)
        if idx[-1] != total_kmers:
            raise ValueError("prefix LUT does not cover all records")
        counts_per_cell = np.diff(idx.astype(np.int64))
        if np.any(counts_per_cell < 0):
            raise ValueError("KMC2 LUT not monotone")
        # k-mer prefix of a record = its LUT cell modulo the per-bin LUT size
        cells = np.repeat(np.arange(n_lut - 1, dtype=np.uint64),
                          counts_per_cell)
        prefixes = cells % np.uint64(n_pref)

    with open(path_base + ".kmc_suf", "rb") as f:
        sdata = f.read()
    if sdata[:4] != SUF_MARKER or sdata[-4:] != SUF_MARKER:
        raise ValueError("not a KMC suffix file (bad markers)")
    body = np.frombuffer(sdata, dtype=np.uint8,
                         count=total_kmers * rec_bytes, offset=4)
    rec = body.reshape(total_kmers, rec_bytes)
    suffix, counts = _decode_suffix_records(rec, suf_sym, suf_bytes,
                                            counter_size)
    kmers = (prefixes << np.uint64(2 * suf_sym)) | suffix
    if kmc_version != 0:                     # bins break global sort order
        order = np.argsort(kmers, kind="stable")
        kmers, counts = kmers[order], counts[order]
    return kmers, counts, k
