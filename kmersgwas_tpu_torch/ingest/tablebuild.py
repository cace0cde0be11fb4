"""k-mers presence/absence table construction.

The port's own copy of kmersgwas_tpu/ingest/tablebuild.py (the port imports
nothing of the JAX package); it reads and writes the same bytes.

Equivalent of `build_kmers_table` (src/build_kmers_table.cpp +
src/kmers_merge_multiple_databaes.cpp): align every sample's sorted k-mer
list against the sorted master list and pack per-sample presence bits into
uint64 words, LSB-first (accession j -> word j//64, bit j%64).

Out-of-core like the reference's 5,000 threshold-bounded passes
(build_kmers_table.cpp:98-103): the master list and every sample list are
read forward through bounded cursors, one k-mer-space range slice at a
time, so peak memory is O(slice) regardless of table size. Within a slice
the reference's hash-join becomes a vectorized `searchsorted` merge — both
sides are sorted, so row order (master-list order) and bytes are identical.
Output format is bit-exact: header AA BB CC DD + uint64 N + uint32 k, then
rows of uint64 kmer + ceil(N/64) words (kmers_merge_multiple_databaes.cpp:54-73).
"""
from __future__ import annotations

import numpy as np

from ..core import codec, formats
from .streamio import SortedListCursor, auto_slices


def presence_words(master: np.ndarray, sample_kmer_lists, chunk_rows: int = 1 << 22):
    """Yield (start_row, pa_words chunk) for the master list vs N samples.

    In-memory variant (tests / small data); `build_table` streams instead.
    """
    n_acc = len(sample_kmer_lists)
    n_words = (n_acc + 63) // 64
    for start in range(0, len(master), chunk_rows):
        chunk = master[start:start + chunk_rows]
        words = np.zeros((len(chunk), n_words), dtype=np.uint64)
        for acc_i, sk in enumerate(sample_kmer_lists):
            idx = np.searchsorted(sk, chunk)
            idx_c = np.minimum(idx, max(len(sk) - 1, 0))
            present = (sk[idx_c] == chunk) if len(sk) else np.zeros(len(chunk), bool)
            words[present, acc_i // 64] |= np.uint64(1 << (acc_i % 64))
        yield start, words


def _slice_words(chunk: np.ndarray, sample_slices) -> np.ndarray:
    """Presence words for one master slice against per-sample slice arrays."""
    n_acc = len(sample_slices)
    n_words = (n_acc + 63) // 64
    words = np.zeros((len(chunk), n_words), dtype=np.uint64)
    for acc_i, sk in enumerate(sample_slices):
        if not len(sk):
            continue
        idx = np.searchsorted(sk, chunk)
        idx_c = np.minimum(idx, len(sk) - 1)
        present = sk[idx_c] == chunk
        words[present, acc_i // 64] |= np.uint64(1 << (acc_i % 64))
    return words


def build_table(sample_list_paths, accession_names, master_list_path,
                out_base: str, k: int, n_slices: int | None = None) -> int:
    """Write `<out_base>.table` + `<out_base>.names`; returns #rows.

    Streams master + sample lists through range-slice cursors (bounded
    memory); byte-identical output for any `n_slices` (auto when None).
    """
    if n_slices is None:
        n_slices = auto_slices([master_list_path, *sample_list_paths])
    bounds = codec.step_bounds(n_slices, k)
    formats.write_names(out_base, accession_names)
    n_rows = 0
    master_cur = SortedListCursor(master_list_path)
    sample_curs = [SortedListCursor(p) for p in sample_list_paths]
    try:
        with open(str(out_base) + ".table", "wb") as f:
            formats.write_table_header(f, len(accession_names), k)
            for bound in bounds:
                chunk = master_cur.read_upto(int(bound))
                slices = [c.read_upto(int(bound)) & codec.KMER_MASK_62
                          for c in sample_curs]
                if len(chunk):
                    words = _slice_words(chunk, slices)
                    formats.write_table_rows(f, chunk, words)
                    n_rows += len(chunk)
                if master_cur.exhausted and all(c.exhausted for c in sample_curs):
                    break
    finally:
        master_cur.close()
        for c in sample_curs:
            c.close()
    return n_rows
