"""Streaming reader of the k-mers presence/absence table.

The port's own copy of kmersgwas_tpu/core/table.py (the port imports
nothing of the JAX package). Its native squeeze is the port's
(kmersgwas_tpu_torch/native); where that cannot be built, the numpy
squeeze gives the same bytes, as in the JAX package.

Equivalent of `MultipleKmersDataBases`
(src/kmers_multiple_databases.{h,cpp}): stream `.table` rows in bounded
batches, "squeeze" the file's accession columns down to the used subset (in
phenotype order, by name — kmers_multiple_databases.cpp:297-311), filter by
minor-allele count on both tails (:103-146), and hand the result to device
kernels as packed **uint32 bit-planes** (samples axis padded to a multiple of
128 lanes) instead of the reference's SSE-ordered 128-bit-padded uint64 rows.

The device layout: batch of R k-mers -> `packed` (R, W32) uint32 where bit b
of word w = sample (32*w + b), LSB-first. Popcounts ride along as f32.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from . import formats

LANE_PAD = 128  # pad samples axis to a multiple of this many bit-lanes


def _pad_words32(n_samples: int) -> int:
    return ((n_samples + LANE_PAD - 1) // LANE_PAD) * (LANE_PAD // 32)


_NATIVE_SQUEEZE = None


def _native_squeeze_available() -> bool:
    """True when the C++ squeeze/pack fast path is usable (cached probe)."""
    global _NATIVE_SQUEEZE
    if _NATIVE_SQUEEZE is None:
        from .. import native
        _NATIVE_SQUEEZE = native.available()
    return _NATIVE_SQUEEZE


@dataclass
class TableBatch:
    """One MAC-filtered batch of table rows, packed for the device."""
    kmers: np.ndarray        # (R,) uint64 canonical k-mer codes
    packed: np.ndarray       # (R, W32) uint32 presence bit-planes, squeezed
    popcnt: np.ndarray       # (R,) float32 = N1 per k-mer over used samples
    row_offset: int          # table row index of kmers[0] BEFORE MAC filter
    row_index: np.ndarray    # (R,) int64 absolute table row of each kept k-mer

    @property
    def n_rows(self) -> int:
        return len(self.kmers)


class KmersTableReader:
    """Batched streaming of a `.table` with column squeeze + MAC filter."""

    def __init__(self, table_base: str, names_to_use=None):
        self.base = str(table_base)
        self.file_names = formats.read_names(self.base)
        self.names = list(names_to_use) if names_to_use is not None else list(self.file_names)
        with open(self.base + ".table", "rb") as f:
            self.header = formats.read_table_header(f)
            f.seek(0, 2)
            body = f.tell() - formats.TableHeader.HEADER_BYTES
        if self.header.n_accessions != len(self.file_names):
            raise ValueError(".names / .table accession count mismatch")
        if body % self.header.row_bytes() != 0:
            raise ValueError("table size is not a whole number of rows")
        self.n_rows_total = body // self.header.row_bytes()

        # squeeze map: used column -> file column (by accession name)
        name_pos = {n: i for i, n in enumerate(self.file_names)}
        try:
            self.file_col = np.array([name_pos[n] for n in self.names], dtype=np.int64)
        except KeyError as e:
            raise ValueError(f"accession not present in table: {e.args[0]}") from None
        self.n_used = len(self.names)
        self.w32 = _pad_words32(self.n_used)
        # mask of file words covering used columns, for the unsqueezed popcount
        wf = self.header.row_words()
        self.file_mask = np.zeros(wf, dtype=np.uint64)
        for c in self.file_col:
            self.file_mask[c // 64] |= np.uint64(1 << (c % 64))

    # -- raw row streaming ---------------------------------------------------

    def iter_raw(self, rows_per_chunk: int, start_row: int = 0,
                 end_row: int | None = None):
        """Yield (start_row, raw rows (R, 1+Wf) uint64) sequentially."""
        wf = self.header.row_words()
        stop = self.n_rows_total if end_row is None else min(end_row,
                                                             self.n_rows_total)
        with open(self.base + ".table", "rb") as f:
            f.seek(formats.TableHeader.HEADER_BYTES
                   + start_row * self.header.row_bytes())
            start = start_row
            while start < stop:
                take = min(rows_per_chunk, stop - start)
                raw = np.fromfile(f, dtype="<u8", count=take * (1 + wf))
                raw = raw.reshape(take, 1 + wf)
                yield start, raw
                start += take

    # -- squeezing -----------------------------------------------------------

    def squeeze_bits(self, raw: np.ndarray) -> np.ndarray:
        """Raw rows -> per-used-sample bit matrix (R, n_used) uint8."""
        word = (self.file_col // 64) + 1
        bit = (self.file_col % 64).astype(np.uint64)
        return ((raw[:, word] >> bit[None, :]) & np.uint64(1)).astype(np.uint8)

    def pack_bits(self, bits: np.ndarray) -> np.ndarray:
        """(R, n_used) 0/1 -> (R, W32) uint32 LSB-first bit-planes."""
        r = bits.shape[0]
        padded = np.zeros((r, self.w32 * 32), dtype=np.uint8)
        padded[:, : self.n_used] = bits
        by = np.packbits(padded, axis=1, bitorder="little")
        return by.view("<u4").reshape(r, self.w32)

    def masked_popcount(self, raw: np.ndarray) -> np.ndarray:
        """Popcount of used columns straight off the file words (uint64)."""
        masked = raw[:, 1:] & self.file_mask[None, :]
        return np.bitwise_count(masked).sum(axis=1, dtype=np.int64)

    # -- batched MAC-filtered loading ----------------------------------------

    def iter_batches(self, batch_size: int, min_count: int,
                     kmers_subset: np.ndarray | None = None,
                     start_row: int = 0, end_row: int | None = None):
        """Yield TableBatch objects of <= batch_size MAC-passing k-mers.

        `min_count` filters both tails: min_count <= N1 <= n_used - min_count
        (kmers_multiple_databases.cpp:118-119). `kmers_subset`, if given,
        restricts rows to a sorted uint64 k-mer set (:117). `end_row` bounds
        the scan to rows [start_row, end_row) — the contiguous host span of
        a range-partitioned multi-process run (parallel/multihost.py).
        """
        pend: list[TableBatch] = []
        pend_rows = 0
        batch_start_row = start_row

        def concat_pending() -> TableBatch:
            return TableBatch(
                kmers=np.concatenate([b.kmers for b in pend]),
                packed=np.concatenate([b.packed for b in pend]),
                popcnt=np.concatenate([b.popcnt for b in pend]),
                row_offset=batch_start_row,
                row_index=np.concatenate([b.row_index for b in pend]),
            )

        use_native = _native_squeeze_available()
        chunk = max(1 << 16, min(batch_size, 1 << 21))
        for start, raw in self.iter_raw(chunk, start_row=start_row,
                                          end_row=end_row):
            if use_native:
                from .. import native
                kmers_all, packed_all, pc, keep = native.squeeze_pack(
                    raw, self.file_col, self.n_used, self.w32, min_count)
                pc = pc.astype(np.int64)
            else:
                pc = self.masked_popcount(raw)
                keep = (pc >= min_count) & (pc <= self.n_used - min_count)
            if kmers_subset is not None and len(kmers_subset):
                idx = np.searchsorted(kmers_subset, raw[:, 0])
                idx_c = np.minimum(idx, len(kmers_subset) - 1)
                keep = keep & (kmers_subset[idx_c] == raw[:, 0])
            kept = np.nonzero(keep)[0]
            if kept.size:
                if use_native:
                    packed = packed_all[kept]
                    kk = kmers_all[kept]
                else:
                    sub = raw[kept]
                    packed = self.pack_bits(self.squeeze_bits(sub))
                    kk = sub[:, 0].copy()
                pend.append(TableBatch(
                    kmers=kk,
                    packed=packed,
                    popcnt=pc[kept].astype(np.float32),
                    row_offset=start,
                    row_index=(start + kept).astype(np.int64),
                ))
                pend_rows += kept.size
            while pend_rows >= batch_size:
                allb = concat_pending()
                yield TableBatch(allb.kmers[:batch_size], allb.packed[:batch_size],
                                 allb.popcnt[:batch_size], allb.row_offset,
                                 allb.row_index[:batch_size])
                rest_rows = pend_rows - batch_size
                if rest_rows:
                    batch_start_row = int(allb.row_index[batch_size])
                    pend = [TableBatch(allb.kmers[batch_size:], allb.packed[batch_size:],
                                       allb.popcnt[batch_size:], batch_start_row,
                                       allb.row_index[batch_size:])]
                else:
                    batch_start_row = start + len(raw)
                    pend = []
                pend_rows = rest_rows
        if pend_rows:
            yield concat_pending()

    # -- convenience ---------------------------------------------------------

    def load_all(self, min_count: int = 0) -> TableBatch:
        """Load the entire table as one batch (tests / small tables)."""
        out = None
        for b in self.iter_batches(batch_size=max(self.n_rows_total, 1),
                                   min_count=min_count):
            out = b
        if out is None:
            out = TableBatch(np.empty(0, np.uint64),
                             np.empty((0, self.w32), np.uint32),
                             np.empty(0, np.float32), 0, np.empty(0, np.int64))
        return out
