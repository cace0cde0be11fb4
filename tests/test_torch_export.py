"""The port's table export (kmersgwas_tpu_torch.pipeline.export and the
CLI's `table-to-bed` and `filter-kmers`) against the JAX package's on the
CPU: every output file and stdout byte-identical.

The table is made with numpy from a seed: 70 accessions (two presence
words a row), k = 31, with runs of rows that repeat one presence pattern,
so the unique-pattern dedup drops rows within a shard and across shards.
The phenotype file lists a subset of the accessions in another order, one
accession the table lacks, and one given twice."""
import numpy as np
import pytest

from kmersgwas_tpu.cli.__main__ import main as jax_cli
from kmersgwas_tpu.core import codec as jcodec
from kmersgwas_tpu.core import formats as jformats
from kmersgwas_tpu.pipeline import export as jexport
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.pipeline import export

K = 31
N = 70


@pytest.fixture(scope="module")
def table(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("export")
    rng = np.random.default_rng(21)
    rows = 900
    kmers = np.sort(rng.choice(1 << 60, size=rows, replace=False)).astype(
        np.uint64)
    kmers = jcodec.canonize(kmers, K)
    kmers = np.unique(kmers)
    rows = len(kmers)
    bits = (rng.random((rows, N)) < rng.uniform(0.05, 0.95, size=(rows, 1))
            ).astype(np.uint8)
    # repeated patterns, within and across the 128-row shards below
    src = rng.integers(0, rows, size=rows // 3)
    dst = rng.integers(0, rows, size=rows // 3)
    bits[dst] = bits[src]
    padded = np.zeros((rows, 128), np.uint8)
    padded[:, :N] = bits
    pa = np.packbits(padded, axis=1, bitorder="little").view("<u8")
    names = [f"acc{i:02d}" for i in range(N)]
    base = str(tmp / "t")
    jformats.write_names(base, names)
    with open(base + ".table", "wb") as f:
        jformats.write_table_header(f, N, K)
        jformats.write_table_rows(f, kmers, pa)
    used = list(rng.permutation(names)[:55]) + ["not_in_table"]
    vals = rng.normal(size=len(used))
    with open(tmp / "p.pheno", "w") as f:
        f.write("accession_id\tphenotype_value\n")
        for a, v in zip(used + used[:1], np.append(vals, 1.5)):
            f.write(f"{a}\t{float(v)!r}\n")
    return dict(base=base, kmers=kmers, bits=bits, names=names,
                pheno=str(tmp / "p.pheno"), tmp=tmp)


def read_tree(paths):
    return [open(p, "rb").read() for p in paths]


@pytest.mark.parametrize("unique", [False, True])
@pytest.mark.parametrize("batch", [128, 5000])
def test_table_to_bed(table, tmp_path, capsys, unique, batch):
    argv = ["table-to-bed", "-t", table["base"], "-p", table["pheno"],
            "--maf", "0.1", "--mac", "3", "-b", str(batch)] \
        + (["-u"] if unique else [])
    outs = {}
    for cli, tag in ((port_cli, "p"), (jax_cli, "j")):
        capsys.readouterr()
        cli(argv + ["-o", str(tmp_path / tag)])
        outs[tag] = capsys.readouterr().out
    assert outs["p"] == outs["j"] and outs["p"].startswith("wrote ")
    n_written = int(outs["p"].split()[1])
    shards = sorted({f.name.split(".")[1] for f in tmp_path.iterdir()
                     if f.name.startswith("p.")})
    assert (len(shards) == 1) == (batch > len(table["kmers"]))
    for s in shards:
        for ext in (".bed", ".bim", ".fam"):
            a, b = read_tree([tmp_path / f"p.{s}{ext}",
                              tmp_path / f"j.{s}{ext}"])
            assert a == b, (s, ext)
    # the bim's k-mers are distinct table rows; with -u their patterns too
    bims = [open(tmp_path / f"p.{s}.bim").read().split("\n")[:-1]
            for s in shards]
    kstrs = [ln.split("\t")[1] for b in bims for ln in b]
    assert len(kstrs) == len(set(kstrs)) == n_written > 0


def test_table_to_bed_dedup_across_shards(table, tmp_path):
    """-u drops a pattern seen in an earlier shard: fewer variants than
    without it, the kept patterns distinct over all shards, equal to the
    JAX package's function."""
    kw = dict(pheno_path=table["pheno"], maf=0.1, mac=3, batch_size=128)
    n_all = export.table_to_bed(table["base"], str(tmp_path / "a"), **kw)
    n_u = export.table_to_bed(table["base"], str(tmp_path / "u"),
                              unique_patterns=True, **kw)
    assert n_u == jexport.table_to_bed(table["base"], str(tmp_path / "j"),
                                       unique_patterns=True, **kw)
    assert 0 < n_u < n_all
    from kmersgwas_tpu_torch.core import formats
    bodies = []
    for s in range(-(-len(table["kmers"]) // 128)):
        base = str(tmp_path / f"u.{s}")
        try:
            bed = open(base + ".bed", "rb").read()[3:]
        except FileNotFoundError:
            break
        n_used = len(formats.read_fam_names(base + ".fam"))
        bpr = (n_used + 3) // 4
        bodies += [bed[i:i + bpr] for i in range(0, len(bed), bpr)]
    assert len(bodies) == n_u == len(set(bodies))


def test_filter_kmers(table, tmp_path, capsys):
    """Queries: table k-mers given as their reverse complements (the
    query is canonized), in random order, beside k-mers the table lacks;
    rows come out in table order."""
    rng = np.random.default_rng(22)
    pick = rng.choice(len(table["kmers"]), size=40, replace=False)
    hits = jcodec.decode_kmers(
        jcodec.reverse_complement(table["kmers"][pick], K), K)
    misses = jcodec.decode_kmers(
        rng.integers(0, 1 << 62, size=10).astype(np.uint64), K)
    queries = list(rng.permutation(hits + misses))
    qfile = tmp_path / "q.txt"
    qfile.write_text(" ".join(queries[:25]) + "\n" + "\n".join(queries[25:]))
    outs = {}
    for cli, tag in ((port_cli, "p"), (jax_cli, "j")):
        capsys.readouterr()
        cli(["filter-kmers", "-t", table["base"], "-k", str(qfile), "-o",
             str(tmp_path / tag)])
        outs[tag] = capsys.readouterr().out
    assert outs["p"] == outs["j"] == "found 40 of 50\n"
    a, b = read_tree([tmp_path / "p", tmp_path / "j"])
    assert a == b
    lines = a.decode().splitlines()
    assert lines[0] == "kmer\t" + "\t".join(table["names"])
    rows = np.sort(pick)
    for ln, r in zip(lines[1:], rows):
        f = ln.split("\t")
        assert f[0] == jcodec.decode_kmers(table["kmers"][r:r + 1], K)[0]
        assert [int(x) for x in f[1:]] == table["bits"][r].tolist()
    assert export.filter_kmers_to_text(table["base"], queries,
                                       str(tmp_path / "f"),
                                       chunk_rows=100) == 40
    assert open(tmp_path / "f", "rb").read() == a
    with pytest.raises(ValueError, match="k-mer length"):
        export.filter_kmers_to_text(table["base"], ["ACGT"],
                                    str(tmp_path / "x"))


@pytest.mark.parametrize("max_rows", [None, 77])
def test_dump_table_textual(table, tmp_path, max_rows):
    got = export.dump_table_textual(table["base"], str(tmp_path / "p"),
                                    max_rows=max_rows, chunk_rows=50)
    want = jexport.dump_table_textual(table["base"], str(tmp_path / "j"),
                                      max_rows=max_rows, chunk_rows=50)
    assert got == want == (max_rows or len(table["kmers"]))
    a, b = read_tree([tmp_path / "p", tmp_path / "j"])
    assert a == b
    first = a.decode().splitlines()[0].split("\t")
    assert first[1] == "".join(map(str, table["bits"][0]))
