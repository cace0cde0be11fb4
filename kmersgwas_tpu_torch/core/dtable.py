"""Device-native table format (.dtable): pre-squeezed packed bit-planes.

A jax-free copy of kmersgwas_tpu/core/dtable.py (that module imports
kmersgwas_tpu.ops.topk, which imports jax): it writes the same bytes and
reads files written by either package.

At the fused kernel's throughput the host-side work of the reference-format
stream (per-batch column squeeze + repack, ~136 B/k-mer for 1008 samples)
becomes the bottleneck. A `.dtable` materializes the squeeze ONCE for a
given accession subset:

  header: magic 'KGTD' | uint32 version | uint64 n_rows | uint32 n_used |
          uint32 w32 | uint32 kmer_len | uint32 min_count_applied |
          uint64 names_hash (v2+)
  body:   contiguous sections —
          kmers   (n_rows) uint64
          popcnt  (n_rows) uint16
          planes  (n_rows, w32) uint32   (LSB-first, lane-padded)
          rows    (n_rows) int64         (source .table row index)
          pop32   (n_rows) float32       (v3+: popcnt pre-cast for the feed)
          row_lo  (n_rows) int32         (v3+: pre-encoded row-id halves,
          row_hi  (n_rows) int32          ops/topk.encode_rows layout)

Streaming a batch is then one memmap slice + one device_put: no unpack, no
popcount, no filtering — and with v3 no per-batch host arithmetic AT ALL
(every array the scan step consumes is a raw zero-copy slice; the
device_put staging copy is the single host byte-touch per byte). Row
indices in the .dtable refer back to the source .table rows so winner
export still resolves against the canonical table.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from ..ops.topk import encode_rows as _encode_rows
from .table import KmersTableReader

MAGIC = b"KGTD"
VERSION = 3     # v2: +names_hash (accession-subset identity)
                # v3: +pop32/row_lo/row_hi zero-prep feed sections
_HDR = struct.Struct("<4sIQIIIIQ")
_HDR_V1 = struct.Struct("<4sIQIIII")


@dataclass
class DTableHeader:
    n_rows: int
    n_used: int
    w32: int
    kmer_len: int
    min_count: int
    names_hash: int | None = None   # None: legacy v1 file (unknown subset)


def names_hash_of(names) -> int:
    """64-bit identity of an ORDERED accession-name list. Column order
    determines the plane bit layout, so the hash covers order too; two
    different same-size subsets (or the same subset reordered) always get
    different dtable identities — reusing a cache across them would silently
    score the wrong accessions' genotype columns."""
    import hashlib
    h = hashlib.blake2b("\n".join(names).encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little")


def build_dtable(table_base: str, out_path: str, *, names_to_use=None,
                 min_count: int = 1, batch_rows: int = 1 << 20,
                 start_row: int = 0,
                 end_row: int | None = None) -> DTableHeader:
    """One streaming pass: .table -> .dtable for the given accession subset,
    dropping rows that fail the two-tail MAC filter at `min_count`.

    start_row/end_row restrict the pass to a contiguous .table row span —
    used by the multi-process drivers so each host caches only its own
    k-mer range (parallel/multihost.host_row_span).

    Fully out-of-core: each section streams to its own spill file as batches
    arrive, then the sections are stitched behind the header — peak memory
    is O(batch), never O(table)."""
    import os
    reader = KmersTableReader(table_base, names_to_use=names_to_use)
    spills = {s: str(out_path) + f".tmp.{s}"
              for s in ("kmers", "popcnt", "planes", "rows",
                        "pop32", "row_lo", "row_hi")}
    n_rows = 0
    fh = {s: open(p, "wb") for s, p in spills.items()}
    try:
        for batch in reader.iter_batches(batch_rows, min_count,
                                         start_row=start_row,
                                         end_row=end_row):
            batch.kmers.astype("<u8").tofile(fh["kmers"])
            batch.popcnt.astype("<u2").tofile(fh["popcnt"])
            np.ascontiguousarray(batch.packed).astype("<u4").tofile(fh["planes"])
            batch.row_index.astype("<i8").tofile(fh["rows"])
            batch.popcnt.astype("<f4").tofile(fh["pop32"])
            lo, hi = _encode_rows(batch.row_index)
            lo.astype("<i4").tofile(fh["row_lo"])
            hi.astype("<i4").tofile(fh["row_hi"])
            n_rows += batch.n_rows
    finally:
        for f in fh.values():
            f.close()
    nhash = names_hash_of(reader.names)
    hdr = DTableHeader(n_rows=n_rows, n_used=reader.n_used, w32=reader.w32,
                       kmer_len=reader.header.kmer_len, min_count=min_count,
                       names_hash=nhash)
    with open(str(out_path), "wb") as f:
        f.write(_HDR.pack(MAGIC, VERSION, n_rows, reader.n_used, reader.w32,
                          reader.header.kmer_len, min_count, nhash))
        for section in ("kmers", "popcnt", "planes", "rows",
                        "pop32", "row_lo", "row_hi"):
            with open(spills[section], "rb") as pf:
                while True:
                    chunk = pf.read(1 << 26)
                    if not chunk:
                        break
                    f.write(chunk)
            os.remove(spills[section])
    return hdr


class DTableReader:
    """Zero-copy batch streaming from a .dtable via memmap sections."""

    def __init__(self, path: str):
        self.path = str(path)
        with open(self.path, "rb") as f:
            raw = f.read(_HDR.size)
        if raw[:4] != MAGIC:
            raise ValueError("not a kmersgwas_tpu .dtable")
        ver = struct.unpack_from("<I", raw, 4)[0]
        if ver == VERSION:
            _, _, n_rows, n_used, w32, klen, minc, nhash = _HDR.unpack(raw)
            off = _HDR.size
            self.hdr = DTableHeader(n_rows, n_used, w32, klen, minc, nhash)
        elif ver == 1:          # legacy: no subset identity — callers must
            _, _, n_rows, n_used, w32, klen, minc = _HDR_V1.unpack(
                raw[:_HDR_V1.size])          # treat as stale (open_cache)
            off = _HDR_V1.size
            self.hdr = DTableHeader(n_rows, n_used, w32, klen, minc, None)
        else:
            raise ValueError(f"unsupported .dtable version {ver}")
        self.kmers = np.memmap(self.path, dtype="<u8", mode="r", offset=off,
                               shape=(n_rows,))
        off += 8 * n_rows
        self.popcnt = np.memmap(self.path, dtype="<u2", mode="r", offset=off,
                                shape=(n_rows,))
        off += 2 * n_rows
        self.planes = np.memmap(self.path, dtype="<u4", mode="r", offset=off,
                                shape=(n_rows, w32))
        off += 4 * n_rows * w32
        self.src_rows = np.memmap(self.path, dtype="<i8", mode="r", offset=off,
                                  shape=(n_rows,))
        off += 8 * n_rows
        if ver >= 3:             # zero-prep feed sections
            self.pop32 = np.memmap(self.path, dtype="<f4", mode="r",
                                   offset=off, shape=(n_rows,))
            off += 4 * n_rows
            self.row_lo = np.memmap(self.path, dtype="<i4", mode="r",
                                    offset=off, shape=(n_rows,))
            off += 4 * n_rows
            self.row_hi = np.memmap(self.path, dtype="<i4", mode="r",
                                    offset=off, shape=(n_rows,))
        else:                    # pre-v3: the feed computes these per batch
            self.pop32 = self.row_lo = self.row_hi = None

    def matches(self, *, min_count: int, n_used: int,
                names_hash: int) -> bool:
        """True iff this cache was built for exactly this filter AND this
        ordered accession subset. A legacy v1 header (no stored hash) never
        matches: (min_count, n_used) alone cannot distinguish two different
        same-size subsets, and reusing such a cache would silently score the
        wrong accessions' columns (ADVICE r4, medium). A v2 cache with a
        matching hash IS valid (the feed computes the v3 sections per batch
        — no forced rebuild of a multi-GB cache)."""
        return (self.hdr.min_count == min_count
                and self.hdr.n_used == n_used
                and self.hdr.names_hash == names_hash)

    def iter_batches(self, batch_size: int, start_row: int = 0):
        """Yield (start, planes, popcnt_f32, src_rows) memmap slices."""
        for s in range(start_row, self.hdr.n_rows, batch_size):
            e = min(s + batch_size, self.hdr.n_rows)
            yield s, self.planes[s:e], self.popcnt[s:e].astype(np.float32), \
                np.asarray(self.src_rows[s:e])


def open_cache(path: str, *, min_count: int, n_used: int, names_hash: int):
    """Open a .dtable cache ONLY if it matches (filter, subset identity);
    returns None when the file is absent, unreadable, a legacy v1 cache, or
    built for a different filter/accession subset — callers then rebuild."""
    import os
    if not os.path.exists(str(path)):
        return None
    try:
        dt = DTableReader(path)
    except (ValueError, struct.error, OSError):
        return None
    return dt if dt.matches(min_count=min_count, n_used=n_used,
                            names_hash=names_hash) else None
