"""The port's own copies of the JAX package's host modules
(kmersgwas_tpu_torch/core/{codec,formats,table}.py and the native squeeze,
kmersgwas_tpu_torch/native) give the JAX package's bytes: header and names
writers, the phenotype reader, and the squeeze + pack of raw table rows on
the identity column map and on a reordered subset."""
import io

import numpy as np
import pytest

from kmersgwas_tpu.core import codec as jcodec
from kmersgwas_tpu.core import formats as jformats
from kmersgwas_tpu.core import table as jtable
from kmersgwas_tpu_torch import native
from kmersgwas_tpu_torch.core import codec, formats, table

N = 150


def write_table(base, n_rows=5000, seed=0):
    rng = np.random.default_rng(seed)
    wf = (N + 63) // 64
    rows = rng.integers(0, 2**64 - 1, size=(n_rows, 1 + wf), dtype=np.uint64,
                        endpoint=True)
    rows[:, 0] = np.sort(rng.integers(0, 4**31, size=n_rows, dtype=np.uint64))
    with open(base + ".table", "wb") as f:
        jformats.write_table_header(f, N, 31)
        rows.astype("<u8").tofile(f)
    names = [f"acc{i}" for i in range(N)]
    jformats.write_names(base, names)
    return names, rows


def squeeze_case(tmp_path, subset):
    base = str(tmp_path / "t")
    names, rows = write_table(base)
    use = (list(np.random.default_rng(1).permutation(names)[:97]) if subset
           else None)
    jr = jtable.KmersTableReader(base, names_to_use=use)
    pr = table.KmersTableReader(base, names_to_use=use)
    np.testing.assert_array_equal(pr.file_col, jr.file_col)
    assert (pr.n_used, pr.w32) == (jr.n_used, jr.w32)
    assert (not subset) == np.array_equal(jr.file_col, np.arange(N))
    got = native.squeeze_pack(rows, pr.file_col, pr.n_used, pr.w32, 5)
    # the JAX package's numpy squeeze (always there) ...
    pc = jr.masked_popcount(rows)
    want = (rows[:, 0], jr.pack_bits(jr.squeeze_bits(rows)), pc,
            (pc >= 5) & (pc <= jr.n_used - 5))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # ... and its native one, where it builds
    from kmersgwas_tpu import native as jnative
    if jnative.available():
        for a, b in zip(got, jnative.squeeze_pack(rows, jr.file_col,
                                                  jr.n_used, jr.w32, 5)):
            np.testing.assert_array_equal(a, b)


def header_case(tmp_path):
    a, b = io.BytesIO(), io.BytesIO()
    formats.write_table_header(a, 1008, 31)
    jformats.write_table_header(b, 1008, 31)
    assert a.getvalue() == b.getvalue()
    a.seek(0)
    got = formats.read_table_header(a)
    want = jformats.read_table_header(io.BytesIO(b.getvalue()))
    assert (got.n_accessions, got.kmer_len) == (want.n_accessions,
                                                want.kmer_len)


def names_case(tmp_path):
    names = ["a", "acc_2", "Col-0", "x" * 40]
    formats.write_names(str(tmp_path / "p"), names)
    jformats.write_names(str(tmp_path / "j"), names)
    assert (tmp_path / "p.names").read_bytes() == \
        (tmp_path / "j.names").read_bytes()
    assert formats.read_names(str(tmp_path / "j")) == names


def phenotypes_case(tmp_path):
    path = tmp_path / "pheno.tsv"
    rng = np.random.default_rng(2)
    vals = rng.normal(size=(30, 3))
    path.write_text("accession_id\tp0\tp1\tp2\n" + "".join(
        f"acc{i}\t" + "\t".join(repr(float(v)) for v in row) + "\n"
        for i, row in enumerate(vals)))
    got, want = formats.read_phenotypes(path), jformats.read_phenotypes(path)
    assert got.accessions == want.accessions and got.names == want.names
    np.testing.assert_array_equal(got.values, want.values)
    assert got.values.dtype == want.values.dtype


def codec_case(tmp_path):
    rng = np.random.default_rng(3)
    kmers = rng.integers(0, 4**31, size=200, dtype=np.uint64)
    assert codec.decode_kmers(kmers, 31) == jcodec.decode_kmers(kmers, 31)
    w64 = rng.integers(0, 2**64 - 1, size=(200, 3), dtype=np.uint64,
                       endpoint=True)
    np.testing.assert_array_equal(codec.pattern_hash(w64),
                                  jcodec.pattern_hash(w64))
    np.testing.assert_array_equal(codec.step_bounds(4, 31),
                                  jcodec.step_bounds(4, 31))


CASES = {"table_header": header_case, "names": names_case,
         "phenotypes": phenotypes_case, "codec": codec_case,
         "squeeze_identity": lambda p: squeeze_case(p, False),
         "squeeze_subset": lambda p: squeeze_case(p, True)}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_copies_give_the_jax_bytes(case, tmp_path):
    CASES[case](tmp_path)


def test_table_reader_native_and_numpy_squeeze_agree(tmp_path, monkeypatch):
    base = str(tmp_path / "t")
    names, _ = write_table(base, n_rows=9000)
    use = names[::-2]
    assert table._native_squeeze_available()

    def batches():
        r = table.KmersTableReader(base, names_to_use=use)
        return [(b.kmers, b.packed, b.popcnt, b.row_index)
                for b in r.iter_batches(4096, 30)]
    with_native = batches()
    monkeypatch.setattr(table, "_NATIVE_SQUEEZE", False)
    for a, b in zip(with_native, batches(), strict=True):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
