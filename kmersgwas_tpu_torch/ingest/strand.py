"""Per-sample strand-flagged k-mer list construction.

The port's own copy of kmersgwas_tpu/ingest/strand.py (the port imports
nothing of the JAX package); it reads and writes the same bytes.

Equivalent of the reference binary `kmers_add_strand_information`
(src/kmers_add_strand_information.cpp): combine the canonized and
non-canonized k-mer count databases of one sample into a single sorted binary
list with a 2-bit strand flag in the MSBs:

  flag 1 (0x4000...): k-mer observed only in canonical orientation
  flag 2 (0x8000...): observed only in non-canonical orientation
  flag 3 (0xC000...): observed in both orientations

The canonized DB defines the key set (it carries the -ci count threshold);
orientation evidence comes from the non-canonized DB. A zero flag (canonized
key never seen in the orientation scan) is an input error, as in the
reference (kmers_add_strand_information.cpp:129-134).
"""
from __future__ import annotations

import numpy as np

from ..core import codec, formats


def strand_flags_from_counts(canon_kmers: np.ndarray,
                             non_canon_kmers: np.ndarray,
                             k: int):
    """Compute (kmers62, flags in {1,2,3}) from the two count databases.

    `canon_kmers`: unique canonical k-mer codes (threshold applied).
    `non_canon_kmers`: unique as-read k-mer codes (threshold 1).
    """
    canon_kmers = np.sort(np.asarray(canon_kmers, dtype=np.uint64))
    nck = np.asarray(non_canon_kmers, dtype=np.uint64)

    canon_of_nc, flag_bits = codec.canon_flags(nck, k)
    # membership of each observed-orientation k-mer in the canonized key set
    idx = np.searchsorted(canon_kmers, canon_of_nc)
    idx_c = np.minimum(idx, len(canon_kmers) - 1) if len(canon_kmers) else idx
    present = np.zeros(len(nck), dtype=bool)
    if len(canon_kmers):
        present = canon_kmers[idx_c] == canon_of_nc

    flags = np.zeros(len(canon_kmers), dtype=np.uint64)
    fwd = flag_bits == codec.FLAG_CANON_ONLY
    np.bitwise_or.at(flags, idx_c[present & fwd], np.uint64(1))
    np.bitwise_or.at(flags, idx_c[present & ~fwd], np.uint64(2))

    if np.any(flags == 0):
        n0 = int((flags == 0).sum())
        raise ValueError(
            f"{n0} canonized k-mers have no orientation evidence; the "
            "non-canonized count DB must be built with min_count=1")
    return canon_kmers, flags


def write_strand_list(path, canon_kmers, non_canon_kmers, k: int) -> None:
    kmers62, flags = strand_flags_from_counts(canon_kmers, non_canon_kmers, k)
    formats.write_strand_kmer_list(path, kmers62, flags)
