"""Table export utilities: presence-pattern queries and bulk PLINK dumps.

The port's own copy of kmersgwas_tpu/pipeline/export.py (the port imports
nothing of the JAX package); it writes the same bytes, host code over
the port's core.table and core.formats.

  * `filter_kmers_to_text` — textual presence/absence of user-supplied
    k-mers (filter_kmers.cpp equivalent): queries are canonized like
    kmer2bits (kmer_general.cpp:260-284), sorted, and matched against the
    sorted table in one streaming merge.
  * `table_to_bed` — stream the whole table into bed/bim/fam shards of at
    most `batch_size` variants with MAF/MAC filtering and optional
    unique-presence-pattern dedup (kmers_table_to_bed.cpp equivalent).
"""
from __future__ import annotations

import math

import numpy as np

from ..core import codec, formats
from ..core.table import KmersTableReader


def filter_kmers_to_text(table_base: str, query_kmers: list, out_path: str,
                         chunk_rows: int = 1 << 20) -> int:
    """Write a TSV of per-accession presence for each query k-mer found.

    `query_kmers` are ACGT strings of the table's k-mer length; returns the
    number of queries found. Output header/row format matches
    filter_kmers.cpp:142-168.
    """
    reader = KmersTableReader(table_base)
    k = reader.header.kmer_len
    if any(len(q) != k for q in query_kmers):
        raise ValueError("all query k-mers must have the table's k-mer length")
    codes = codec.canonize(codec.encode_kmers(query_kmers), k)
    order = np.argsort(codes, kind="stable")
    sorted_q = codes[order]

    n = reader.header.n_accessions
    found = 0
    with open(out_path, "w") as f:
        f.write("kmer" + "".join(f"\t{a}" for a in reader.file_names) + "\n")
        for start, raw in reader.iter_raw(chunk_rows):
            idx = np.searchsorted(sorted_q, raw[:, 0])
            idx_c = np.minimum(idx, len(sorted_q) - 1)
            hit = sorted_q[idx_c] == raw[:, 0]
            rows = np.nonzero(hit)[0]
            if not len(rows):
                continue
            found += len(rows)
            shifts = np.arange(64, dtype=np.uint64)
            bits = ((raw[rows, 1:, None] >> shifts) & np.uint64(1)
                    ).reshape(len(rows), -1)[:, :n]
            strs = codec.decode_kmers(raw[rows, 0], k)
            for s, b in zip(strs, bits):
                f.write(s + "".join(f"\t{int(x)}" for x in b) + "\n")
    return found


def table_to_bed(table_base: str, out_base: str, *, pheno_path: str,
                 maf: float, mac: int, batch_size: int,
                 unique_patterns: bool = False) -> int:
    """Stream table -> PLINK shards `<out_base>.<i>.bed/bim/fam`.

    Accessions are restricted/ordered to the phenotype file's, as the
    reference does (kmers_table_to_bed.cpp:92-103). Returns #variants written.
    """
    pheno = formats.read_phenotypes(pheno_path)
    table_names = set(formats.read_names(table_base))
    used, vals = [], []
    for a, v in zip(pheno.accessions, pheno.values[:, 0]):
        if a in table_names:
            used.append(a)
            vals.append(v)
    reader = KmersTableReader(table_base, names_to_use=used)
    k = reader.header.kmer_len
    min_count = max(mac, math.ceil(len(used) * maf))

    seen_patterns = np.empty(0, dtype=np.uint64)
    n_written = 0
    shard = 0
    for batch in reader.iter_batches(batch_size, min_count):
        packed64 = np.ascontiguousarray(batch.packed).view("<u8")
        keep = np.ones(batch.n_rows, dtype=bool)
        if unique_patterns:
            h = codec.pattern_hash(packed64)
            uniq_h, first = np.unique(h, return_index=True)
            mask_first = np.zeros(batch.n_rows, dtype=bool)
            mask_first[first] = True
            idx = np.searchsorted(seen_patterns, h)
            idx_c = np.minimum(idx, max(len(seen_patterns) - 1, 0))
            already = (seen_patterns[idx_c] == h) if len(seen_patterns) else \
                np.zeros(batch.n_rows, dtype=bool)
            keep = mask_first & ~already
            seen_patterns = np.union1d(seen_patterns, uniq_h)
        rows = np.nonzero(keep)[0]
        base = f"{out_base}.{shard}"
        with formats.BedBimWriter(base) as w:
            names = codec.decode_kmers(batch.kmers[rows], k)
            # trim packed planes to the bed word count
            n64 = (reader.n_used + 63) // 64
            w.write_variants(names, packed64[rows][:, :n64], reader.n_used)
        formats.write_fam(base + ".fam", used, np.asarray(vals))
        n_written += len(rows)
        shard += 1
    return n_written


def dump_table_textual(table_base: str, out, max_rows: int | None = None,
                       chunk_rows: int = 1 << 18) -> int:
    """Textual k-mer + presence-bit dump (output_kmers_textual equivalent,
    kmers_multiple_databases.cpp:162-171): per row the k-mer string and the
    accession bits in column order (the reference prints each uint64 word
    bit-reversed so bit 0 = first accession; emitting bits directly in
    accession order is the same rendering)."""
    reader = KmersTableReader(table_base)
    n = reader.header.n_accessions
    k = reader.header.kmer_len
    written = 0
    close = False
    if isinstance(out, str):
        out = open(out, "w")
        close = True
    try:
        for start, raw in reader.iter_raw(chunk_rows):
            shifts = np.arange(64, dtype=np.uint64)
            bits = ((raw[:, 1:, None] >> shifts) & np.uint64(1)
                    ).reshape(len(raw), -1)[:, :n]
            strs = codec.decode_kmers(raw[:, 0], k)
            for s, b in zip(strs, bits):
                out.write(s + "\t" + "".join("1" if x else "0" for x in b) + "\n")
                written += 1
                if max_rows and written >= max_rows:
                    return written
    finally:
        if close:
            out.close()
    return written
