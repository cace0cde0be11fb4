"""The port's host ingest (kmersgwas_tpu_torch.ingest, its native ingest
library and the CLI's `count`, `strand-merge`, `list-kmers`,
`build-table`, `kmc-import`, `kmc-export` and `histogram`) against the JAX
package's numpy route on the CPU.

Every input is made with numpy from a seed. Each case runs the command
through both CLIs (the JAX one with --no-native) and holds the port's
stdout and every output file byte-identical to the JAX package's, on both
of the port's routes: the native library and --no-native. The modules are
also held function by function (the slice counts of the out-of-core
stages, the KMC layouts and their error)."""
import concurrent.futures
import gzip
import os
import struct

import numpy as np
import pytest

from kmersgwas_tpu.cli.__main__ import main as jax_cli
from kmersgwas_tpu.ingest import counter as jcounter
from kmersgwas_tpu.ingest import kmc as jkmc
from kmersgwas_tpu.ingest import strand as jstrand
from kmersgwas_tpu.ingest import streamio as jstreamio
from kmersgwas_tpu.ingest import tablebuild as jtablebuild
from kmersgwas_tpu.ingest import union as junion
from kmersgwas_tpu_torch import native
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.ingest import counter, kmc, strand, streamio
from kmersgwas_tpu_torch.ingest import tablebuild, union

K = 15
ROUTES = ("native", "numpy")


def random_reads(rng, n, length, p_invalid=0.02):
    """n reads of `length` bases, ACGT plus N and lower case at
    p_invalid / 2 each."""
    p = [(1 - p_invalid) / 4] * 4 + [p_invalid / 2] * 2
    sym = rng.choice(6, size=(n, length), p=p)
    return ["".join("ACGTNa"[b] for b in row) for row in sym]


def write_reads(path, reads, fmt):
    if fmt == "fasta":
        # records split over lines, as FASTA files wrap
        text = "".join(f">r{i}\n{s[:50]}\n{s[50:]}\n"
                       for i, s in enumerate(reads))
    else:
        text = "".join(f"@r{i}\n{s}\n+\n{'I' * len(s)}\n"
                       for i, s in enumerate(reads))
    if path.endswith(".gz"):
        with gzip.open(path, "wt") as f:
            f.write(text)
    else:
        with open(path, "w") as f:
            f.write(text)


def run(cli, argv, capsys):
    """(stdout) of one CLI call."""
    capsys.readouterr()
    cli(argv)
    return capsys.readouterr().out


def port_argv(argv, route):
    return argv + (["--no-native"] if route == "numpy" else [])


def read_bytes(*paths):
    return [open(p, "rb").read() for p in paths]


def test_native_ingest_library_builds_apart_from_the_squeeze():
    assert native.ingest_available()
    assert native.available()
    lib = native.load_ingest()
    assert "libkgt_ingest_" in lib._name and "squeeze" not in lib._name


def test_threads_that_build_at_once_each_load_the_library(tmp_path,
                                                         monkeypatch):
    """Four threads reach the first build of one library together, as the
    CLI's `count` called from a thread pool does: each compiles into a
    temporary file of its own, every thread loads the library, and no
    temporary file is left behind."""
    monkeypatch.setattr(native, "BUILD", str(tmp_path / "build"))
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        libs = list(ex.map(lambda _: native._build("squeeze", native.SOURCE),
                           range(4)))
    names = {lib._name for lib in libs}
    assert len(names) == 1
    assert os.listdir(tmp_path / "build") == [os.path.basename(names.pop())]


def test_cli_takes_the_numpy_route_where_the_library_does_not_build(
        tmp_path, capsys, monkeypatch):
    """An ingest source that does not compile: ingest_available() is
    False, the squeeze still builds, and `count` takes the numpy route
    (told on stderr) with the JAX package's bytes."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("#include <no_such_header_here.h>\n")
    monkeypatch.setattr(native, "INGEST_SOURCE", str(bad))
    native.load_ingest.cache_clear()
    try:
        assert not native.ingest_available()
        assert native.available()
        fq = str(tmp_path / "r.fq")
        write_reads(fq, random_reads(np.random.default_rng(2), 20, 70),
                    "fastq")
        capsys.readouterr()
        port_cli(["count", "-k", str(K), "-o", str(tmp_path / "p"), fq])
        got = capsys.readouterr()
        assert got.err == "count: numpy route\n"
        want = run(jax_cli, ["count", "-k", str(K), "-o",
                             str(tmp_path / "j"), "--no-native", fq], capsys)
        assert got.out == want
        assert read_bytes(tmp_path / "p") == read_bytes(tmp_path / "j")
    finally:
        native.load_ingest.cache_clear()


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("min_count", [1, 2, 3])
@pytest.mark.parametrize("canonize", [True, False])
@pytest.mark.parametrize("fmt", ["fasta", "fastq", "fastq.gz"])
def test_count(tmp_path, capsys, fmt, canonize, min_count, route):
    rng = np.random.default_rng(
        ["fasta", "fastq", "fastq.gz"].index(fmt) * 8 + canonize * 4
        + min_count)
    # short genomes read at depth, so counts reach min_count
    genome = random_reads(rng, 1, 400, p_invalid=0.01)[0]
    reads = [genome[s:s + 90] for s in rng.integers(0, 310, size=40)]
    reads += random_reads(rng, 5, 60)
    ext = {"fasta": ".fa", "fastq": ".fq", "fastq.gz": ".fq.gz"}[fmt]
    paths = [str(tmp_path / f"r{i}{ext}") for i in range(2)]
    write_reads(paths[0], reads[:25], fmt.split(".")[0])
    write_reads(paths[1], reads[25:], fmt.split(".")[0])
    argv = ["count", "-k", str(K), "--min_count", str(min_count)] \
        + (["--canonize"] if canonize else [])
    got = run(port_cli, port_argv(argv + ["-o", str(tmp_path / "p.bin")],
                                  route) + paths, capsys)
    want = run(jax_cli, argv + ["-o", str(tmp_path / "j.bin"),
                                "--no-native"] + paths, capsys)
    assert got == want and int(want.split()[0]) > 0
    a, b = read_bytes(tmp_path / "p.bin", tmp_path / "j.bin")
    assert a == b
    kk, cc = counter.count_kmers_in_files(paths, K, canonize, min_count)
    jk, jc = jcounter.count_kmers_in_files(paths, K, canonize, min_count)
    assert np.array_equal(kk, jk) and np.array_equal(cc, jc)
    assert cc.min() >= min_count


def test_count_drops_windows_over_invalid_bases(tmp_path):
    fq = tmp_path / "r.fq"
    fq.write_text("@a\nACGTNACGTACGTACGTACG\n+\n" + "I" * 20 + "\n"
                  "@b\nTTTTTTTTTTTTTTTTTT\n+\n" + "I" * 18 + "\n")
    for route in ROUTES:
        out = tmp_path / f"{route}.bin"
        if route == "native":
            native.count([fq], K, False, 1, out)
        else:
            kk, cc = counter.count_kmers_in_files([fq], K, canonize=False)
            rec = np.empty(len(kk), dtype=[("k", "<u8"), ("c", "<u8")])
            rec["k"], rec["c"] = kk, cc
            rec.tofile(out)
    want = jcounter.count_kmers_in_files([fq], K, canonize=False)
    for route in ROUTES:
        rec = np.fromfile(tmp_path / f"{route}.bin",
                          dtype=[("k", "<u8"), ("c", "<u8")])
        assert np.array_equal(rec["k"], want[0])
        assert np.array_equal(rec["c"], want[1])
    # "ACGTN..." leaves one 15-mer window after the N; "T" * 18 four
    assert list(want[1]) == [1, 4]


def test_kmers_of_sequence_and_histogram():
    rng = np.random.default_rng(3)
    for seq in random_reads(rng, 6, 70, p_invalid=0.1) + ["ACG", ""]:
        got = counter.kmers_of_sequence(seq.encode(), K)
        assert np.array_equal(got,
                              jcounter.kmers_of_sequence(seq.encode(), K))
    counts = rng.integers(1, 30, size=500).astype(np.uint64)
    for c in (counts, np.empty(0, np.uint64)):
        assert np.array_equal(counter.counts_histogram(c),
                              jcounter.counts_histogram(c))


def sample_counts(tmp_path, rng, tag, n_reads=30):
    """One sample's canonized (min_count 2) and as-read count files, made
    by the JAX package's numpy counter."""
    genome = random_reads(rng, 1, 300, p_invalid=0.0)[0]
    reads = [genome[s:s + 80] for s in rng.integers(0, 220, size=n_reads)]
    comp = str.maketrans("ACGT", "TGCA")
    reads = [r[::-1].translate(comp) if i % 2 else r
             for i, r in enumerate(reads)]
    fa = str(tmp_path / f"{tag}.fa")
    write_reads(fa, reads, "fasta")
    paths = []
    for canon, mc, suffix in ((True, 2, "canon"), (False, 1, "nonc")):
        kk, cc = jcounter.count_kmers_in_files([fa], K, canon, mc)
        rec = np.empty(len(kk), dtype=[("k", "<u8"), ("c", "<u8")])
        rec["k"], rec["c"] = kk, cc
        path = str(tmp_path / f"{tag}.{suffix}")
        rec.tofile(path)
        paths.append(path)
    return paths


@pytest.mark.parametrize("route", ROUTES)
def test_strand_merge(tmp_path, capsys, route):
    canon, nonc = sample_counts(tmp_path, np.random.default_rng(4), "s")
    argv = ["strand-merge", "-c", canon, "-n", nonc, "-k", str(K)]
    got = run(port_cli, port_argv(argv + ["-o", str(tmp_path / "p")], route),
              capsys)
    want = run(jax_cli, argv + ["-o", str(tmp_path / "j"), "--no-native"],
               capsys)
    assert got == want
    a, b = read_bytes(tmp_path / "p", tmp_path / "j")
    assert a == b and len(a) > 0
    flags = np.fromfile(tmp_path / "p", "<u8") >> np.uint64(62)
    assert set(flags.tolist()) == {1, 2, 3}
    ck, nk = (np.fromfile(x, dtype=[("k", "<u8"), ("c", "<u8")])["k"]
              for x in (canon, nonc))
    for a, b in zip(strand.strand_flags_from_counts(ck, nk, K),
                    jstrand.strand_flags_from_counts(ck, nk, K)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("route", ROUTES)
def test_strand_merge_without_orientation_evidence_raises(tmp_path, route):
    """A canonized k-mer that the as-read counts never saw: the native
    route's -2 and the numpy route's check both raise ValueError, with the
    JAX package's messages."""
    canon, nonc = sample_counts(tmp_path, np.random.default_rng(5), "e")
    rec = np.fromfile(nonc, dtype=[("k", "<u8"), ("c", "<u8")])
    rec[::3].tofile(nonc)              # drop orientation evidence
    argv = port_argv(["strand-merge", "-c", canon, "-n", nonc, "-k", str(K),
                      "-o", str(tmp_path / "p")], route)
    with pytest.raises(ValueError) as got:
        port_cli(argv)
    if route == "native":
        assert str(got.value) == (
            "canonized k-mers without orientation evidence "
            "(non-canonized counts must use min_count=1)")
    else:
        ck = np.fromfile(canon, dtype=[("k", "<u8"), ("c", "<u8")])["k"]
        with pytest.raises(ValueError) as want:
            jstrand.strand_flags_from_counts(ck, rec[::3]["k"], K)
        assert str(got.value) == str(want.value)


def strand_lists(tmp_path, n_samples=7, seed=6):
    """n_samples strand lists (JAX package's numpy route) and the
    '<path> <name>' list file -> (paths, names, list file)."""
    rng = np.random.default_rng(seed)
    # samples share a pool of genomes, so k-mers recur across samples
    pool = [random_reads(rng, 1, 300, p_invalid=0.0)[0] for _ in range(3)]
    paths, names = [], []
    for s in range(n_samples):
        genome = pool[s % 3][:200] + pool[(s + 1) % 3][200:]
        reads = [genome[o:o + 80] for o in rng.integers(0, 220, size=30)]
        comp = str.maketrans("ACGT", "TGCA")
        reads = [r[::-1].translate(comp) if rng.random() < 0.5 else r
                 for r in reads]
        fa = str(tmp_path / f"acc{s}.fa")
        write_reads(fa, reads, "fasta")
        ck, _ = jcounter.count_kmers_in_files([fa], K, True, 2)
        nk, _ = jcounter.count_kmers_in_files([fa], K, False, 1)
        path = str(tmp_path / f"acc{s}.kmers")
        jstrand.write_strand_list(path, ck, nk, K)
        paths.append(path)
        names.append(f"acc{s}")
    lst = tmp_path / "lists.txt"
    lst.write_text("".join(f"{p} {a}\n" for p, a in zip(paths, names)))
    return paths, names, str(lst)


UNION_SUFFIXES = ("", ".no_pass_kmers", ".shareness",
                  ".stats.only_canonical", ".stats.only_non_canonical",
                  ".stats.both")


@pytest.mark.parametrize("route", ROUTES)
def test_list_kmers_and_build_table(tmp_path, capsys, route):
    paths, names, lst = strand_lists(tmp_path)
    argv = ["list-kmers", "-l", lst, "-k", str(K), "--mac", "2", "-p", "0.3"]
    got = run(port_cli, port_argv(argv + ["-o", str(tmp_path / "pm")],
                                  route), capsys)
    want = run(jax_cli, argv + ["-o", str(tmp_path / "jm"), "--no-native"],
               capsys)
    assert got == want and got.startswith("passed kmers:\t")
    for suffix in UNION_SUFFIXES:
        a, b = read_bytes(str(tmp_path / "pm") + suffix,
                          str(tmp_path / "jm") + suffix)
        assert a == b, suffix
    nopass = open(str(tmp_path / "jm.no_pass_kmers")).read().splitlines()
    assert len(nopass) > 1            # the strand filter removed some

    argv = ["build-table", "-l", lst, "-k", str(K), "-a",
            str(tmp_path / "jm")]
    got = run(port_cli, port_argv(argv + ["-o", str(tmp_path / "pt")],
                                  route), capsys)
    want = run(jax_cli, argv + ["-o", str(tmp_path / "jt"), "--no-native"],
               capsys)
    assert got == want and got.startswith("rows: ")
    for ext in (".table", ".names"):
        a, b = read_bytes(str(tmp_path / "pt") + ext,
                          str(tmp_path / "jt") + ext)
        assert a == b, ext


@pytest.mark.parametrize("n_slices", [1, 3, None])
def test_out_of_core_stages_at_any_slice_count(tmp_path, n_slices):
    """build_master_list and build_table write the JAX package's bytes
    (at its automatic slice count) whatever the port's slice count."""
    paths, names, _ = strand_lists(tmp_path, seed=8)
    n_j, stats_j = junion.build_master_list(paths, tmp_path / "jm", K, 2,
                                            0.2)
    n_p, stats_p = union.build_master_list(paths, tmp_path / "pm", K, 2,
                                           0.2, n_slices=n_slices)
    assert n_p == n_j > 0
    for f in ("shareness", "only_canonical", "only_non_canonical",
              "both_forms"):
        assert np.array_equal(getattr(stats_p, f), getattr(stats_j, f))
    for suffix in UNION_SUFFIXES:
        a, b = read_bytes(str(tmp_path / "pm") + suffix,
                          str(tmp_path / "jm") + suffix)
        assert a == b, suffix
    rows_j = jtablebuild.build_table(paths, names, tmp_path / "jm",
                                     str(tmp_path / "jt"), K)
    rows_p = tablebuild.build_table(paths, names, tmp_path / "pm",
                                    str(tmp_path / "pt"), K,
                                    n_slices=n_slices)
    assert rows_p == rows_j == n_j
    for ext in (".table", ".names"):
        a, b = read_bytes(str(tmp_path / "pt") + ext,
                          str(tmp_path / "jt") + ext)
        assert a == b, ext
    assert streamio.auto_slices(paths) == jstreamio.auto_slices(paths)


def test_union_filter_and_presence_words():
    rng = np.random.default_rng(10)
    ks = [np.unique(rng.integers(0, 60, size=30)).astype(np.uint64)
          for _ in range(4)]
    fs = [rng.integers(1, 4, size=len(k)).astype(np.uint8) for k in ks]
    got = union.union_counts(ks, fs)
    want = junion.union_counts(ks, fs)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    for p in (0.0, 0.2, 0.5):
        for a, b in zip(union.filter_union(*got, 2, p),
                        junion.filter_union(*want, 2, p)):
            assert np.array_equal(a, b)
    # the ceil(p * count_all) edge: 100 samples at p = 0.2 need 20 a side
    c_all = np.array([100, 100])
    keep, _, _ = union.filter_union(np.array([5, 6], np.uint64), c_all,
                                    np.array([0, 0]), np.array([81, 80]),
                                    1, 0.2)
    assert list(keep) == [False, True]
    master = np.unique(np.concatenate(ks))
    for (s0, w0), (s1, w1) in zip(
            tablebuild.presence_words(master, ks, chunk_rows=16),
            jtablebuild.presence_words(master, ks, chunk_rows=16)):
        assert s0 == s1 and np.array_equal(w0, w1)


def test_sorted_list_cursor(tmp_path):
    rng = np.random.default_rng(11)
    words = np.sort(rng.integers(0, 1 << 40, size=1000).astype(np.uint64))
    words |= rng.integers(1, 4, size=1000).astype(np.uint64) << np.uint64(62)
    path = tmp_path / "l"
    words.tofile(path)
    bounds = np.sort(rng.integers(0, 1 << 40, size=9))
    with streamio.SortedListCursor(path, chunk_words=37) as a, \
            jstreamio.SortedListCursor(path, chunk_words=37) as b:
        for bd in list(bounds) + [(1 << 62) - 1]:
            assert np.array_equal(a.read_upto(int(bd)), b.read_upto(int(bd)))
        assert a.exhausted and b.exhausted and a.n_read == 1000


def kmc_case(seed, k, n=200):
    rng = np.random.default_rng(seed)
    space = 1 << min(2 * k, 40)
    kmers = np.sort(rng.choice(space, size=n, replace=False)).astype(
        np.uint64)
    return kmers, rng


@pytest.mark.parametrize("k,counter_size,lut,strands", [
    (15, 1, 1, True), (21, 2, 8, False), (25, 3, 1, False),
    (31, 4, 8, True)])
def test_kmc_write_and_read(tmp_path, k, counter_size, lut, strands):
    """KMC1 and KMC2 databases: the port writes the JAX package's bytes
    and reads its own and the JAX package's back (a cut of the fuzz grid
    of tests/test_formats_ingest.py)."""
    kmers, rng = kmc_case(k * 10 + counter_size, k)
    cmax = (1 << (8 * counter_size)) - 1
    counts = rng.integers(1, min(cmax, 10**6) + 1, size=len(kmers)).astype(
        np.uint64)
    for version in (1, 2):
        kw = (dict(lut_prefix_len=min(lut + 4, 12, k - 1))
              if version == 1 else
              dict(lut_prefix_len=min(lut, k - 1),
                   signature_len=min(5, k - 1), n_bins=16))
        bases = []
        for mod, tag in ((kmc, "p"), (jkmc, "j")):
            base = str(tmp_path / f"{tag}{version}")
            write = mod.write_kmc1 if version == 1 else mod.write_kmc2
            write(base, kmers, counts, k, counter_size=counter_size,
                  both_strands=strands, **kw)
            bases.append(base)
        for ext in (".kmc_pre", ".kmc_suf"):
            a, b = read_bytes(bases[0] + ext, bases[1] + ext)
            assert a == b, (version, ext)
        for base in bases:
            k2, c2, klen = kmc.read_kmc(base)
            assert klen == k
            assert np.array_equal(k2, kmers) and np.array_equal(c2, counts)
    assert np.array_equal(kmc.minimizer_signature(kmers, k, 5),
                          jkmc.minimizer_signature(kmers, k, 5))


def test_kmc_odd_headers_and_many_bins(tmp_path):
    """A header larger than the known struct still reads (forward
    compatibility); the KMC2 layout at 512 bins and signature length 9;
    an unknown version raises the JAX package's NotImplementedError."""
    kmers, rng = kmc_case(7, 21, n=64)
    counts = rng.integers(1, 100, size=64).astype(np.uint64)
    base = str(tmp_path / "fwd")
    kmc.write_kmc1(base, kmers, counts, 21, lut_prefix_len=3)
    raw = open(base + ".kmc_pre", "rb").read()
    version, hdr_size = struct.unpack("<II", raw[-12:-4])
    body_end = len(raw) - 12 - hdr_size
    patched = (raw[:body_end + hdr_size] + b"\xEE" * 8
               + struct.pack("<II", version, hdr_size + 8) + raw[-4:])
    open(base + ".kmc_pre", "wb").write(patched)
    for mod in (kmc, jkmc):
        k2, c2, klen = mod.read_kmc(base)
        assert klen == 21
        assert np.array_equal(k2, kmers) and np.array_equal(c2, counts)

    kmers, rng = kmc_case(123, 25, n=3000)
    counts = rng.integers(1, 1000, size=3000).astype(np.uint64)
    base = str(tmp_path / "db512")
    kmc.write_kmc2(base, kmers, counts, 25, lut_prefix_len=2,
                   signature_len=9, n_bins=512, counter_size=3)
    k2, c2, klen = kmc.read_kmc(base)
    assert klen == 25
    assert np.array_equal(k2, kmers) and np.array_equal(c2, counts)

    patched = (raw[:-12] + struct.pack("<II", 0x300, hdr_size) + raw[-4:])
    open(base + ".kmc_pre", "wb").write(patched)
    msgs = []
    for mod in (kmc, jkmc):
        with pytest.raises(NotImplementedError) as e:
            mod.read_kmc(base)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == "KMC database version 0x300 not supported"


def test_kmc_export_import_and_histogram_cli(tmp_path, capsys):
    """kmc-export -> kmc-import round trip and histogram of a count file,
    stdout and files byte-identical to the JAX CLI's."""
    canon, _ = sample_counts(tmp_path, np.random.default_rng(12), "h",
                             n_reads=60)
    outs = {}
    for cli, tag in ((port_cli, "p"), (jax_cli, "j")):
        base = str(tmp_path / f"{tag}db")
        outs[tag] = [
            run(cli, ["kmc-export", canon, "-k", str(K), "-o", base],
                capsys),
            run(cli, ["kmc-import", base, "-o", base + ".counts"], capsys),
            run(cli, ["histogram", base + ".counts"], capsys)]
        outs[tag] += read_bytes(base + ".kmc_pre", base + ".kmc_suf",
                                base + ".counts")
    assert outs["p"] == outs["j"]
    assert outs["p"][5] == open(canon, "rb").read()
    hist = outs["p"][2].splitlines()
    assert hist[0] == "appearance\tcount" and len(hist) > 3
