"""The port's multi-process gwas (kmersgwas_tpu_torch.pipeline.gwas.
run_distributed_gwas and the CLI `gwas-mp`) on the CPU, on
test_pipeline's synthetic population: in one process against the JAX
package's run_distributed_gwas, given the same transform (test_torch_gwas's
comparison of artifacts), and in one and two processes against the port's
own single-process `run_gwas`, which tests/test_torch_gwas.py holds to the
JAX package's.

`gwas-mp` scans with the multi-process step (`cand_c`, K3's plain version
here) on each process's span, `gwas` with `cand_w` (K1's); with
--certify_topk both rank their candidates by exact f64 re-scores, and on
dyadic transformed phenotypes their float32 scores are exact, so either
way the two select the same top-k in the same order and write the same
artifacts: every file byte-identical but summary.json (which gains
"n_processes") and log_file (stage times)."""
import json
import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import kmersgwas_tpu_torch.pipeline.gwas as pgwas
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli

from test_pipeline import K, build_population
from test_torch_gwas import KW, assert_same_artifacts, shared_transform  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["-l", str(K), "-k", "30", "--permutations", "20", "--maf", "0.05",
        "--mac", "2", "--batch_size", "500", "--min_data_points", "10",
        "--lmm_backend", "host64", "--device", "cpu"]
TIMEOUT = 240


@pytest.fixture(scope="module")
def pop(tmp_path_factory):
    return build_population(tmp_path_factory.mktemp("pop"), n_samples=60,
                            n_kmers=500, seed=5, causal_effect=3.0)


def read_tree(out):
    files = {}
    for root, _, fs in os.walk(out):
        for f in fs:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, out)] = fh.read()
    return files


def assert_same_gwas(mp, one, n_processes):
    """Every file byte-identical but log_file and summary.json; the
    summary's keys and values equal but stage_seconds, plus n_processes."""
    assert sorted(mp) == sorted(one)
    assert any(f.endswith(".bed") for f in one)
    assert "kmers/output/phenotype_value.assoc.txt.gz" in one
    diff = [f for f in one if f not in ("log_file", "summary.json")
            and mp[f] != one[f]]
    assert not diff, diff
    sm, so = (json.loads(x["summary.json"]) for x in (mp, one))
    assert sm.pop("n_processes") == n_processes
    assert sorted(sm) == sorted(so)
    for key in so:
        assert key == "stage_seconds" or sm[key] == so[key], key


def fresh_table(pop, tmp_path, tag):
    """A copy of the population's table per run: gwas caches the kinship
    beside the table, and each run must compute its own."""
    base = str(tmp_path / tag)
    for ext in (".table", ".names"):
        with open(pop["base"] + ext, "rb") as f, open(base + ext, "wb") as g:
            g.write(f.read())
    return base


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(code_or_args, n_proc, tmp_path):
    """n_proc processes over gloo on 127.0.0.1: `python -m
    kmersgwas_tpu_torch.cli <args> --process_id i`, or `python -c code i
    port` -> their outputs; every process is stopped on a timeout."""
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=ROOT)
    if isinstance(code_or_args, str):
        cmds = [[sys.executable, "-c", code_or_args, str(i), str(port)]
                for i in range(n_proc)]
    else:
        cmds = [[sys.executable, "-m", "kmersgwas_tpu_torch.cli",
                 *code_or_args, "--coordinator", f"127.0.0.1:{port}",
                 "--num_processes", str(n_proc), "--process_id", str(i)]
                for i in range(n_proc)]
    procs = [subprocess.Popen(c, env=env, cwd=tmp_path,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for c in cmds]
    outs = []
    try:
        for pr in procs:
            outs.append(pr.communicate(timeout=TIMEOUT)[0].decode(
                errors="replace"))
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    for pr, out in zip(procs, outs):
        assert pr.returncode == 0, out[-3000:]
    return outs


def test_gwas_mp_two_processes_write_the_gwas_bytes(pop, tmp_path, capsys):
    one_table = fresh_table(pop, tmp_path, "one")
    capsys.readouterr()
    port_cli(["gwas", "--pheno", str(pop["pheno_path"]), "--kmers_table",
              one_table, "--outdir", str(tmp_path / "one"),
              "--certify_topk", *ARGS])
    one_line = capsys.readouterr().out
    mp_table = fresh_table(pop, tmp_path, "mp")
    outs = run_ranks(["gwas-mp", "--pheno", str(pop["pheno_path"]),
                      "--kmers_table", mp_table, "--outdir",
                      str(tmp_path / "mp"), "--certify_topk", *ARGS], 2,
                     tmp_path)
    # the CLI's line, wherever the ranks' stderr put theirs
    assert one_line.strip() in outs[0].splitlines()
    assert ("process 1: scan complete (process 0 writes the results)"
            in outs[1].splitlines())
    assert "pass_5per=0 " not in one_line
    mp, one = read_tree(tmp_path / "mp"), read_tree(tmp_path / "one")
    assert_same_gwas(mp, one, n_processes=2)
    # the distributed kinship, persisted by process 0, is the one-process
    # kinship's bytes
    assert open(mp_table + ".kinship", "rb").read() == \
        open(one_table + ".kinship", "rb").read()
    assert "computing kinship from k-mers table (distributed)" in \
        mp["log_file"].decode()


@pytest.fixture
def dyadic_transform(monkeypatch):
    """The port's transform with its transformed table rounded to
    multiples of 1/32: float32 scores are then exact in any order."""
    orig = pgwas.transform_mod.transform_and_permute

    def dyadic(y, Kmat, n_perm, seed=0, check_psd=True):
        tr = orig(y, Kmat, n_perm, seed=seed)
        tr.transformed = np.clip(np.round(tr.transformed * 32), -255,
                                 255) / 32
        return tr
    monkeypatch.setattr(pgwas.transform_mod, "transform_and_permute", dyadic)


@pytest.mark.parametrize("certify", [False, True])
def test_run_distributed_gwas_one_process(pop, tmp_path, dyadic_transform,
                                          certify):
    """In one process (no process group) run_distributed_gwas writes
    run_gwas's bytes, with and without certify_topk, a larger heap for
    column 0 and the pattern counter."""
    outs = {}
    for tag, fn in (("one", pgwas.run_gwas),
                    ("mp", pgwas.run_distributed_gwas)):
        cfg = pgwas.GWASConfig(
            pheno_path=str(pop["pheno_path"]),
            kmers_table=fresh_table(pop, tmp_path, tag),
            outdir=str(tmp_path / tag), kmer_len=K, n_kmers=30,
            n_permutations=12, maf=0.05, mac=2, batch_size=300,
            min_data_points=10, pattern_counter=True,
            n_extra_phenotype_kmers=45, lmm_backend="host64", device="cpu",
            certify_topk=certify)
        res = fn(cfg)
        outs[tag] = (res, read_tree(tmp_path / tag))
    assert_same_gwas(outs["mp"][1], outs["one"][1], n_processes=1)
    (a, _), (b, _) = outs["mp"], outs["one"]
    assert a.thresholds == b.thresholds and a.pass_5per == b.pass_5per
    assert a.n_tested == b.n_tested > 0


@pytest.mark.parametrize("extra", [
    dict(),
    dict(n_extra_phenotype_kmers=45, pattern_counter=True,
         remove_intermediates=False)])
def test_run_distributed_gwas_matches_jax(pop, tmp_path, shared_transform,
                                          extra):
    """One process each, the JAX package's run_distributed_gwas and the
    port's on one transform (the JAX package's, made dyadic): the
    distributed kinship, the distributed scan and stages 5-6 write the
    same artifacts (fixed-width files byte for byte; best_pvals,
    summary.json with its n_processes and the assoc tables parsed, as
    test_torch_gwas compares `gwas`). The JAX package's has no certify."""
    import kmersgwas_tpu.pipeline.gwas as jgwas
    kw = dict(KW, pheno_path=str(pop["pheno_path"]), **extra)
    want = jgwas.run_distributed_gwas(jgwas.GWASConfig(
        kmers_table=fresh_table(pop, tmp_path, "jax"),
        outdir=str(tmp_path / "jax"), **kw))
    got = pgwas.run_distributed_gwas(pgwas.GWASConfig(
        kmers_table=fresh_table(pop, tmp_path, "port"),
        outdir=str(tmp_path / "port"), device="cpu", **kw))
    files = read_tree(tmp_path / "jax")
    assert json.loads(files["summary.json"])["n_processes"] == 1
    assert ("kmers/output/P20.assoc.txt" in files) == \
        ("remove_intermediates" in extra)
    assert_same_artifacts(read_tree(tmp_path / "port"), files)
    assert open(str(tmp_path / "port") + ".kinship", "rb").read() == \
        open(str(tmp_path / "jax") + ".kinship", "rb").read()
    assert got.pass_5per and [s for s, _ in got.pass_5per] == \
        [s for s, _ in want.pass_5per]
    assert got.n_tested == want.n_tested > 0


@pytest.mark.parametrize("flags", [
    dict(run_snps="one_step", snps_matrix="x"),
    dict(kinship_snps=True, snps_matrix="x"),
    dict(run_kmers=False)])
def test_snp_flags_raise(tmp_path, flags):
    cfg = pgwas.GWASConfig(pheno_path="p", kmers_table="t",
                           outdir=str(tmp_path), kmer_len=K, device="cpu",
                           **flags)
    with pytest.raises(ValueError, match="single-process only"):
        pgwas.run_distributed_gwas(cfg)


def test_cuda_without_a_card_raises(tmp_path, monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = pgwas.GWASConfig(pheno_path="p", kmers_table="t",
                           outdir=str(tmp_path), kmer_len=K, device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        pgwas.run_distributed_gwas(cfg)


BROADCAST = textwrap.dedent("""
    import sys
    import numpy as np
    import torch.distributed as dist
    from kmersgwas_tpu_torch.parallel import sharding
    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=2, rank=rank)
    rng = np.random.default_rng(7)
    a = rng.normal(size=(61, 21)) * 10.0 ** rng.integers(-300, 300,
                                                         size=(61, 21))
    bits = a.view(np.uint64)
    bits[0, :4] = [0x7FF8000000000001, 0xFFF0000000000000,
                   0x8000000000000000, 1]      # NaN payload, -inf, -0, min
    b = (rng.random(13) * 1e-30).astype(np.float32)     # 52 bytes
    if rank:
        a, b = np.zeros_like(a), np.zeros_like(b)
    got = [sharding.broadcast_np(x) for x in (a, b)]
    print(got[0].tobytes().hex() + " " + got[1].tobytes().hex())
    dist.destroy_process_group()
""")


def test_broadcast_is_bit_exact(tmp_path):
    """The transform's broadcast: float64 (and a float32 payload of an odd
    word count) arrive bit for bit, NaN payload and signed zero included."""
    outs = run_ranks(BROADCAST, 2, tmp_path)
    lines = [o.strip().splitlines()[-1] for o in outs]
    assert lines[0] == lines[1]
    raw = bytes.fromhex(lines[1].split()[0])
    got = np.frombuffer(raw, np.uint64).reshape(61, 21)
    assert list(got[0, :4]) == [0x7FF8000000000001, 0xFFF0000000000000,
                                0x8000000000000000, 1]
    assert np.count_nonzero(got) > 61 * 21 - 4


def test_example_runs_on_the_cpu(tmp_path, capsys):
    """The port's example (reads -> table -> gwas -> gwas-mp) on the CPU:
    cassette k-mers pass, and gwas-mp's pass set is gwas's."""
    from kmersgwas_tpu_torch.examples import simulated_ecoli_like as ex
    ex.main([str(tmp_path / "ex"), "--device", "cpu"])
    out = capsys.readouterr().out
    assert "example OK" in out
    assert "gwas-mp pass-set overlap with single-process: 100%" in out
    kdir = tmp_path / "ex" / "gwas_results" / "kmers"
    mp_kdir = tmp_path / "ex" / "gwas_results_mp" / "kmers"
    assert (kdir / "pass_threshold_5per").read_bytes() == \
        (mp_kdir / "pass_threshold_5per").read_bytes()


def test_checkpoints_per_process(pop, tmp_path):
    """--checkpoint gives each process `<base>.kin.p<pid>.npz` and
    `<base>.scan.p<pid>.npz`; a rerun resumes from them to the same
    artifacts."""
    table = fresh_table(pop, tmp_path, "t")
    ck = str(tmp_path / "ck")
    trees = []
    for i in range(2):
        if os.path.exists(table + ".kinship"):
            os.remove(table + ".kinship")
        cfg = pgwas.GWASConfig(
            pheno_path=str(pop["pheno_path"]), kmers_table=table,
            outdir=str(tmp_path / f"o{i}"), kmer_len=K, n_kmers=30,
            n_permutations=8, maf=0.05, mac=2, batch_size=128,
            min_data_points=10, lmm_backend="host64", device="cpu",
            certify_topk=True, checkpoint_base=ck, checkpoint_every=1)
        pgwas.run_distributed_gwas(cfg)
        assert os.path.exists(ck + ".kin.p0.npz")
        assert os.path.exists(ck + ".scan.p0.npz")
        trees.append(read_tree(tmp_path / f"o{i}"))
    assert sorted(trees[0]) == sorted(trees[1])
    diff = [f for f in trees[0] if f not in ("log_file", "summary.json")
            and trees[0][f] != trees[1][f]]
    assert not diff, diff


def test_gwas_mp_crash_resume(tmp_path, capsys):
    """Port of tests/test_multiprocess.py:580-685 with 3 processes whose
    k-mer spans are uneven (the codes crowd the low end of the k-mer
    space): every `gwas-mp` process is SIGKILLed once all three scan
    checkpoints exist (before any result is written); the same command
    run again resumes from them and writes a single-process `gwas`'s
    artifacts byte for byte (both with --certify_topk, so the ranks do not
    depend on the scan step's f32 sums)."""
    import signal
    import time
    from kmersgwas_tpu_torch.core import formats
    from kmersgwas_tpu_torch.parallel import multihost

    rng = np.random.default_rng(88)
    rows, n, kmer_len, n_proc = 12000, 32, 15, 3
    codes = np.unique((rng.random(3 * rows) ** 3
                       * (1 << 2 * kmer_len)).astype(np.uint64))
    kmers = np.sort(rng.choice(codes, size=rows, replace=False))
    bits = np.zeros((rows, 64), dtype=np.uint8)
    bits[:, :n] = rng.integers(0, 2, size=(rows, n))
    pa = np.packbits(bits, axis=1, bitorder="little").view("<u8")
    names = [f"acc{i}" for i in range(n)]
    tables = {}
    for tag in ("mp", "one"):
        base = str(tmp_path / f"{tag}_pop")
        formats.write_names(base, names)
        with open(base + ".table", "wb") as f:
            formats.write_table_header(f, n, kmer_len)
            formats.write_table_rows(f, kmers, pa)
        tables[tag] = base
    spans = [multihost.host_row_span(tables["mp"], i, n_proc)
             for i in range(n_proc)]
    sizes = [e - s for s, e in spans]
    assert sum(sizes) == rows and max(sizes) > 2 * min(sizes) > 0, sizes
    pheno = str(tmp_path / "t.pheno")
    formats.write_phenotypes(pheno, formats.PhenotypeTable(
        names=["phenotype_value"], accessions=names,
        values=rng.normal(size=(n, 1))))
    ck = str(tmp_path / "ck")
    common = ["--pheno", pheno, "-l", str(kmer_len), "-k", "12",
              "--permutations", "12", "--maf", "0.05", "--mac", "2",
              "--batch_size", "384", "--min_data_points", "10", "--seed",
              "0", "--lmm_backend", "host64", "--device", "cpu",
              "--certify_topk"]
    mp_args = ["gwas-mp", "--kmers_table", tables["mp"], "--outdir",
               str(tmp_path / "mp"), "--checkpoint", ck,
               "--checkpoint_every", "1", *common]

    # attempt 1: kill every process once all scan checkpoints exist
    port = _free_port()
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmersgwas_tpu_torch.cli", *mp_args,
         "--coordinator", f"127.0.0.1:{port}", "--num_processes",
         str(n_proc), "--process_id", str(i)],
        env=dict(os.environ, PYTHONPATH=ROOT), cwd=tmp_path,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for i in range(n_proc)]
    scan_cks = [f"{ck}.scan.p{i}.npz" for i in range(n_proc)]
    deadline = time.time() + TIMEOUT
    try:
        while time.time() < deadline and any(pr.poll() is None
                                             for pr in procs):
            if all(os.path.exists(p) for p in scan_cks):
                break
            time.sleep(0.02)
        interrupted = all(os.path.exists(p) for p in scan_cks) and \
            all(pr.poll() is None for pr in procs)
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.send_signal(signal.SIGKILL)
        outs = [pr.communicate()[0].decode(errors="replace") for pr in procs]
    assert interrupted, "\n".join(o[-2000:] for o in outs)
    assert not (tmp_path / "mp" / "kmers" / "threshold_5per").exists()
    done = [int(np.load(p)["n_tested"]) for p in scan_cks]
    assert 0 < sum(done) < rows

    # attempt 2: the same command resumes from the per-process checkpoints
    run_ranks(mp_args, n_proc, tmp_path)
    capsys.readouterr()
    port_cli(["gwas", "--kmers_table", tables["one"], "--outdir",
              str(tmp_path / "one"), *common])
    assert_same_gwas(read_tree(tmp_path / "mp"), read_tree(tmp_path / "one"),
                     n_processes=n_proc)
