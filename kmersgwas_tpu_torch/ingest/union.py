"""Master k-mer list: union of per-sample lists with MAC + strand filters.

The port's own copy of kmersgwas_tpu/ingest/union.py (the port imports
nothing of the JAX package); it reads and writes the same bytes.

Equivalent of `list_kmers_found_in_multiple_samples`
(src/list_kmers_found_in_multiple_samples.cpp). For every k-mer across the N
per-sample strand lists, count:

  count_all        — samples containing the k-mer
  count_canon      — samples where it appeared ONLY in canonical form (flag 1)
  count_non_canon  — ONLY non-canonical (flag 2)
  count_both       — both forms (flag 3) = all - canon - non_canon

A k-mer passes if count_all >= mac AND each orientation is supported by at
least ceil(p * count_all) samples, counting 'both' toward each side
(list_kmers_found_in_multiple_samples.cpp:185-199).

Like the reference (hash accumulation over 5,000 sequential range slices,
list_kmers_found_in_multiple_samples.cpp:144-151) the build walks k-mer
space in bounded range slices, so memory stays O(slice) however large the
sample lists are; within each slice the counts come from a vectorized
sorted reduction instead of a hash. The same slice boundaries
range-partition the space for multi-host runs (each host owns a contiguous
62-bit range — see parallel/sharding.py).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import codec, formats
from .streamio import SortedListCursor, auto_slices


@dataclass
class UnionStats:
    """Shareness + per-(count_all, count_form) matrices, as emitted by the
    reference alongside the master list (…:209-218)."""
    shareness: np.ndarray             # (N+1,) counts for PASSING k-mers
    only_canonical: np.ndarray        # (N+1, N+1)
    only_non_canonical: np.ndarray    # (N+1, N+1)
    both_forms: np.ndarray            # (N+1, N+1)


def union_counts(kmer_arrays, flag_arrays):
    """Merge per-sample (kmers62, flags) -> unique kmers + 3 count vectors."""
    all_k = np.concatenate(kmer_arrays) if kmer_arrays else np.empty(0, np.uint64)
    all_f = np.concatenate(flag_arrays) if flag_arrays else np.empty(0, np.uint8)
    order = np.argsort(all_k, kind="stable")
    all_k, all_f = all_k[order], all_f[order]
    uniq, start = np.unique(all_k, return_index=True)
    seg = np.searchsorted(all_k, uniq)  # == start
    count_all = np.diff(np.append(seg, len(all_k)))
    seg_id = np.repeat(np.arange(len(uniq)), count_all)
    count_canon = np.bincount(seg_id, weights=(all_f == 1), minlength=len(uniq)).astype(np.int64)
    count_non = np.bincount(seg_id, weights=(all_f == 2), minlength=len(uniq)).astype(np.int64)
    return uniq, count_all.astype(np.int64), count_canon, count_non


def filter_union(uniq, count_all, count_canon, count_non, mac: int, min_strand_frac: float):
    """Apply the MAC + two-sided strand-fraction filter; returns pass mask."""
    count_both = count_all - count_canon - count_non
    need = np.ceil(min_strand_frac * count_all.astype(np.float64))
    pass_mac = count_all >= mac
    pass_strand = (((count_canon + count_both).astype(np.float64) >= need)
                   & ((count_non + count_both).astype(np.float64) >= need))
    return pass_mac & pass_strand, pass_mac, count_both


def build_master_list(sample_list_paths, out_path, k: int, mac: int,
                      min_strand_frac: float, collect_stats: bool = True,
                      n_slices: int | None = None):
    """Full pipeline stage: N strand lists -> sorted master list + stats.

    Out-of-core: k-mer space is walked in `n_slices` contiguous range slices
    (auto-sized from the input volume when None; the reference fixes 5,000,
    list_kmers_found_in_multiple_samples.cpp:144-151) with each sample file
    read forward through a bounded cursor, so peak memory is O(slice), not
    O(total). Output is byte-identical for any slice count because slices
    partition the sorted k-mer space.

    Writes `out_path` (binary uint64 list, no flags) and, like the reference,
    `out_path + ".no_pass_kmers"` (textual), `.shareness`, `.stats.*`.
    Returns (n_pass, UnionStats | None).
    """
    n_samples = len(sample_list_paths)
    if n_slices is None:
        n_slices = auto_slices(sample_list_paths)
    bounds = codec.step_bounds(n_slices, k)
    nn = n_samples + 1
    share = np.zeros(nn, dtype=np.int64)
    mats = {s: np.zeros((nn, nn), dtype=np.int64)
            for s in ("only_canonical", "only_non_canonical", "both")}
    n_pass = 0

    cursors = [SortedListCursor(p) for p in sample_list_paths]
    try:
        with open(str(out_path), "wb") as out_f, \
                open(str(out_path) + ".no_pass_kmers", "w") as np_f:
            np_f.write("kmer\tcount_all\tcanonical\tnon-canonical\tboth\n")
            for bound in bounds:
                slabs = [c.read_upto(int(bound)) for c in cursors]
                if not any(len(s) for s in slabs):
                    if all(c.exhausted for c in cursors):
                        break
                    continue
                kmer_arrays = [s & codec.KMER_MASK_62 for s in slabs]
                flag_arrays = [(s >> np.uint64(62)).astype(np.uint8) for s in slabs]
                uniq, c_all, c_can, c_non = union_counts(kmer_arrays, flag_arrays)
                keep, pass_mac, c_both = filter_union(uniq, c_all, c_can, c_non,
                                                      mac, min_strand_frac)
                uniq[keep].astype("<u8").tofile(out_f)
                n_pass += int(keep.sum())

                idxs = np.nonzero(pass_mac & ~keep)[0]
                if idxs.size:
                    strs = codec.decode_kmers(uniq[idxs], k)
                    for s, i in zip(strs, idxs):
                        np_f.write(f"{s}\t{c_all[i]}\t{c_can[i]}\t{c_non[i]}"
                                   f"\t{c_both[i]}\n")
                if collect_stats:
                    share += np.bincount(c_all[keep], minlength=nn)[:nn]
                    np.add.at(mats["only_canonical"], (c_all, c_can), 1)
                    np.add.at(mats["only_non_canonical"], (c_all, c_non), 1)
                    np.add.at(mats["both"], (c_all, c_both), 1)
    finally:
        for c in cursors:
            c.close()

    stats = None
    if collect_stats:
        stats = UnionStats(shareness=share,
                           only_canonical=mats["only_canonical"],
                           only_non_canonical=mats["only_non_canonical"],
                           both_forms=mats["both"])
        with open(str(out_path) + ".shareness", "w") as f:
            f.write("kmer appearance\tcount\n")
            for i, v in enumerate(share):
                f.write(f"{i}\t{v}\n")
        for suffix, m in (("only_canonical", stats.only_canonical),
                          ("only_non_canonical", stats.only_non_canonical),
                          ("both", stats.both_forms)):
            np.savetxt(str(out_path) + f".stats.{suffix}", m, fmt="%d", delimiter="\t")
    return n_pass, stats
