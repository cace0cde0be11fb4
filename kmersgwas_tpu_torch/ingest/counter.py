"""Host-side k-mer counting from FASTQ/FASTA (KMC-equivalent front end).

The port's own copy of kmersgwas_tpu/ingest/counter.py (the port imports
nothing of the JAX package); it reads and writes the same bytes.

The reference delegates counting to the external KMC 3 binary
(SURVEY.md L0; the reference ships no counter of its own). Here counting
is first-party: reads are 2-bit packed and k-mers extracted with a rolling
window, vectorized in NumPy. k-mers containing non-ACGT symbols are dropped,
like KMC does.

Two counting modes, matching the reference's dual-KMC-run protocol
(examples/resistence_e_coli/run_example.sh):
  * canonized:  count min(kmer, revcomp) with a minimum-count threshold (-ci)
  * non-canonized: count k-mers as read, threshold 1 (-ci1)
"""
from __future__ import annotations

import gzip

import numpy as np

from ..core import codec

_CODE_LUT = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _CODE_LUT[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    _CODE_LUT[_b] = _c


def _open_maybe_gz(path):
    p = str(path)
    if p.endswith(".gz"):
        return gzip.open(p, "rb")
    return open(p, "rb")


def iter_read_sequences(path):
    """Yield raw sequence bytes from FASTQ or FASTA (optionally gzipped)."""
    with _open_maybe_gz(path) as f:
        first = f.peek(1)[:1] if hasattr(f, "peek") else b"@"
        if first == b">":  # FASTA
            seq_parts = []
            for line in f:
                line = line.strip()
                if line.startswith(b">"):
                    if seq_parts:
                        yield b"".join(seq_parts)
                        seq_parts = []
                else:
                    seq_parts.append(line)
            if seq_parts:
                yield b"".join(seq_parts)
        else:  # FASTQ: 4-line records
            while True:
                header = f.readline()
                if not header:
                    break
                seq = f.readline().strip()
                f.readline()
                f.readline()
                if seq:
                    yield seq


def kmers_of_sequence(seq: bytes, k: int) -> np.ndarray:
    """All valid k-mer codes of one read (rolling 2-bit window, vectorized)."""
    sym = _CODE_LUT[np.frombuffer(seq, dtype=np.uint8)]
    n = sym.shape[0]
    if n < k:
        return np.empty(0, dtype=np.uint64)
    valid = sym != 255
    # prefix "codes" via cumulative shift trick: code[i] = sum sym[j] << 2*(k-1-(j-i))
    s = sym.astype(np.uint64)
    win = np.lib.stride_tricks.sliding_window_view(s, k)
    shifts = np.arange(2 * (k - 1), -2, -2, dtype=np.uint64)
    kcodes = (win << shifts[None, :]).sum(axis=1, dtype=np.uint64)
    ok = np.lib.stride_tricks.sliding_window_view(valid, k).all(axis=1)
    return kcodes[ok]


def count_kmers_in_files(paths, k: int, canonize: bool, min_count: int = 1):
    """Count k-mers across read files -> (sorted unique codes, counts).

    Counts saturate at uint32. Matches KMC semantics used by the pipeline:
    canonized runs use `min_count` = -ci threshold; non-canonized runs use 1.
    """
    chunks = []
    for path in paths:
        for seq in iter_read_sequences(path):
            km = kmers_of_sequence(seq, k)
            if km.size:
                chunks.append(km)
    if not chunks:
        return np.empty(0, dtype=np.uint64), np.empty(0, dtype=np.uint64)
    allk = np.concatenate(chunks)
    if canonize:
        allk = codec.canonize(allk, k)
    uniq, counts = np.unique(allk, return_counts=True)
    if min_count > 1:
        keep = counts >= min_count
        uniq, counts = uniq[keep], counts[keep]
    return uniq, counts.astype(np.uint64)


def counts_histogram(counts: np.ndarray) -> np.ndarray:
    """Histogram of k-mer multiplicities (histogram_KMC_kmers_counts.cpp:66-71):
    hist[c] = number of distinct k-mers appearing exactly c times."""
    counts = np.asarray(counts, dtype=np.int64)
    if counts.size == 0:
        return np.zeros(1, dtype=np.int64)
    return np.bincount(counts)
