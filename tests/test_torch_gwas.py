"""The port's gwas pipeline (kmersgwas_tpu_torch.pipeline.gwas and the
CLI `gwas`) against the JAX package's on the CPU, on test_pipeline's
synthetic populations.

The permutation draws of the two packages differ (numpy against
jax.random), so the parity tests give both pipelines one shared
TransformResult, the JAX package's (it carries across as plain numpy
arrays), with the transformed table rounded to multiples of 1/32: on such
dyadic phenotypes the two scans' float32 scores are bit-equal (as in
tests/test_torch_scan.py), so their top-k and ranks are too; the exact
LMM then runs on the untransformed columns. Artifacts printed at fixed
width must be byte-identical; best_pvals and summary.json print full
floats and are parsed (rtol 1e-9), as is assoc.txt (l_mle and p_lrt at
rtol 1e-6; k-mer, rank and af equal).
"""
import gzip
import io
import json
import math
import os
import shutil

import jax
import numpy as np
import pytest
import torch

import kmersgwas_tpu.pipeline.gwas as jgwas
from kmersgwas_tpu.cli.__main__ import main as jax_cli
from kmersgwas_tpu.core import codec
from kmersgwas_tpu.stats import transform as jtransform
import kmersgwas_tpu_torch.pipeline.gwas as pgwas
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.pipeline import scan as pscan

from test_pipeline import K, build_population
from test_torch_snps import (assert_lmm_fields, assert_same_snp_artifacts,
                             random_dubits, write_bed)

KW = dict(kmer_len=K, n_kmers=30, n_permutations=20, maf=0.05, mac=2,
          batch_size=500, min_data_points=10, lmm_grid=32, lmm_refine=25)


@pytest.fixture(scope="module")
def pop(tmp_path_factory):
    return build_population(tmp_path_factory.mktemp("pop"), n_samples=60,
                            n_kmers=500, seed=5, causal_effect=3.0)


@pytest.fixture
def shared_transform(monkeypatch):
    """Both packages' transform_and_permute return one TransformResult:
    the JAX package's (under x64), its transformed table made dyadic."""
    orig = jtransform.transform_and_permute
    cache = {}

    def shared(y, Kmat, n_perm, seed=0, check_psd=True):
        if "tr" not in cache:
            with jax.enable_x64(True):
                tr = orig(y, Kmat, n_perm, seed=seed)
            tr.transformed = np.clip(np.round(tr.transformed * 32),
                                     -255, 255) / 32
            cache["tr"] = tr
        return cache["tr"]
    monkeypatch.setattr(jgwas.transform_mod, "transform_and_permute", shared)
    monkeypatch.setattr(pgwas.transform_mod, "transform_and_permute", shared)
    return cache


def read_tree(out):
    files = {}
    for root, _, fs in os.walk(out):
        for f in fs:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, out)] = fh.read()
    return files


def parse_assoc(raw):
    rows = [ln.split("\t") for ln in raw.decode().splitlines()]
    assert rows[0] == ["chr", "rs", "ps", "n_miss", "allele1", "allele0",
                       "af", "l_mle", "p_lrt"]
    return rows[1:]


def assert_lmm_close(a, b):
    """l_mle and p_lrt strings at rtol 1e-6 (module docstring)."""
    np.testing.assert_allclose([float(v) for v in a],
                               [float(v) for v in b], rtol=1e-6)


def assert_same_artifacts(got, want, lmm_fields=assert_lmm_close):
    """Byte-identical but for the full-float and timing files; those
    parsed (module docstring), assoc.txt's l_mle and p_lrt by
    `lmm_fields`."""
    assert sorted(got) == sorted(want)
    parsed = [f for f in want if f in ("summary.json", "log_file",
                                       "kmers/best_pvals")
              or ".assoc.txt" in f]
    assert any(f.endswith(".bed") for f in want)
    for f in want:
        if f not in parsed:
            assert got[f] == want[f], f
    for f in parsed:
        if ".assoc.txt" not in f:
            continue
        op = gzip.decompress if f.endswith(".gz") else bytes
        g, w = parse_assoc(op(got[f])), parse_assoc(op(want[f]))
        assert len(g) == len(w) > 0
        for a, b in zip(g, w):
            assert a[:7] == b[:7], f          # k-mer_rank, af
            lmm_fields(a[7:], b[7:])
    bg, bw = (dict(ln.split("\t") for ln in x["kmers/best_pvals"].decode()
                   .splitlines()) for x in (got, want))
    assert list(bg) == list(bw)
    np.testing.assert_allclose([float(v) for v in bg.values()],
                               [float(v) for v in bw.values()], rtol=1e-9)
    sg, sw = (json.loads(x["summary.json"]) for x in (got, want))
    assert sorted(sg) == sorted(sw)
    for key, v in sw.items():
        if key == "stage_seconds":
            continue
        if isinstance(v, float):
            assert math.isclose(sg[key], v, rel_tol=1e-9), key
        else:
            assert sg[key] == v, key


def test_run_gwas_matches_jax(tmp_path, pop, shared_transform):
    """The same transform in: the same bed/bim/fam of every column,
    tested k-mers, thresholds, pass files and assoc tables
    (--dont_remove_intermediates keeps them all)."""
    kw = dict(KW, pheno_path=str(pop["pheno_path"]),
              kmers_table=pop["base"], remove_intermediates=False)
    want = jgwas.run_gwas(jgwas.GWASConfig(outdir=str(tmp_path / "jax"),
                                           **kw))
    got = pgwas.run_gwas(pgwas.GWASConfig(outdir=str(tmp_path / "port"),
                                          device="cpu", **kw))
    files = read_tree(tmp_path / "jax")
    assert "kmers/output/P20.assoc.txt" in files
    assert_same_artifacts(read_tree(tmp_path / "port"), files)
    assert got.pass_5per and [s for s, _ in got.pass_5per] == \
        [s for s, _ in want.pass_5per]
    np.testing.assert_allclose([p for _, p in got.pass_5per],
                               [p for _, p in want.pass_5per], rtol=1e-6)
    for key in ("5per", "10per"):
        assert math.isclose(got.thresholds[key], want.thresholds[key],
                            rel_tol=1e-9)
    assert got.n_tested == want.n_tested
    assert got.heritability == want.heritability
    assert {"transform", "scan", "lmm", "artifacts"} <= set(
        got.stage_seconds)


def test_cli_gwas_matches_jax_cli(tmp_path, pop, shared_transform,
                                  capsys):
    """`gwas --device cpu` against the JAX CLI's `gwas`: the same files,
    the permutation PLINK files removed and assoc.txt gzipped
    (mtime 0), and the same result line."""
    args = ["--pheno", str(pop["pheno_path"]), "--kmers_table", pop["base"],
            "-l", str(K), "-k", "30", "--permutations", "20", "--mac", "2",
            "--min_data_points", "10", "--batch_size", "500"]
    jax_cli(["gwas", "--outdir", str(tmp_path / "jax")] + args)
    want_line = capsys.readouterr().out.strip()
    port_cli(["gwas", "--outdir", str(tmp_path / "port"), "--device",
              "cpu"] + args)
    got_line = capsys.readouterr().out.strip()
    files = read_tree(tmp_path / "jax")
    assert "kmers/output/phenotype_value.assoc.txt.gz" in files
    assert "kmers/pheno.1.P1.bed" not in files
    assert_same_artifacts(read_tree(tmp_path / "port"), files)
    (g_th, g_rest), (w_th, w_rest) = (
        ln.split(" ", 1) for ln in (got_line, want_line))
    assert g_rest == w_rest and g_th.split("=")[0] == "threshold_5per"
    assert math.isclose(float(g_th.split("=")[1]),
                        float(w_th.split("=")[1]), rel_tol=1e-9)


def gwas_cfg(pop, outdir, **kw):
    return pgwas.GWASConfig(pheno_path=str(pop["pheno_path"]),
                            kmers_table=pop["base"], outdir=str(outdir),
                            device="cpu", **dict(KW, **kw))


def test_port_gwas_finds_causal_kmer(tmp_path):
    """test_pipeline.test_full_gwas_finds_causal_kmer, on the port with its
    own transform and permutation draws."""
    pop = build_population(tmp_path, n_samples=60, n_kmers=500, seed=5,
                           causal_effect=3.0)
    res = pgwas.run_gwas(gwas_cfg(pop, tmp_path / "out"))
    assert res.n_tested > 0
    causal = codec.decode_kmers(np.array([pop["causal"]], np.uint64), K)[0]
    assert any(s == causal for s, _ in res.pass_5per), (
        causal, res.pass_5per[:5], res.thresholds)
    assert min(res.pass_5per, key=lambda t: t[1])[0] == causal
    out = tmp_path / "out"
    for f in ["kmers/threshold_5per", "kmers/best_pvals", "summary.json",
              "pheno.phenotypes_permuted_transformed",
              "kmers/pheno.tested_kmers", "log_file", "pheno.kinship",
              "kmers/output/phenotype_value.assoc.txt.gz"]:
        assert (out / f).exists(), f
    assert json.loads((out / "summary.json").read_text())[
        "lmm_backend"] == "host64"
    assert "stage] kinship" in (out / "log_file").read_text()


def test_not_enough_data(tmp_path, pop):
    with pytest.raises(ValueError, match="phenotyped accessions"):
        pgwas.run_gwas(gwas_cfg(pop, tmp_path / "out", min_data_points=61))
    assert (tmp_path / "out" / "NOT_ENOUGH_DATA").exists()


def test_kinship_sources(tmp_path, monkeypatch):
    """Kinship from the table is cached beside it, and the cache is read
    on the next run; --kinship takes a precomputed matrix; a read-only
    table directory falls back into outdir. All give the same result."""
    pop = build_population(tmp_path, n_samples=40, n_kmers=300, seed=12,
                           causal_effect=3.0)
    cache = pop["base"] + ".kinship"
    r1 = pgwas.run_gwas(gwas_cfg(pop, tmp_path / "o1"))
    assert os.path.exists(cache)
    assert "kinship" in r1.stage_seconds
    r2 = pgwas.run_gwas(gwas_cfg(pop, tmp_path / "o2"))
    assert "kinship" not in r2.stage_seconds
    os.rename(cache, tmp_path / "given.kinship")
    r3 = pgwas.run_gwas(gwas_cfg(pop, tmp_path / "o3",
                                 kinship_path=str(tmp_path / "given.kinship")))
    assert "kinship" not in r3.stage_seconds and not os.path.exists(cache)
    orig = pgwas.kinship_mod.write_kinship

    def deny_beside_table(path, Kmat):
        if str(path) == cache:
            raise OSError(30, "Read-only file system")
        return orig(path, Kmat)
    monkeypatch.setattr(pgwas.kinship_mod, "write_kinship",
                        deny_beside_table)
    r4 = pgwas.run_gwas(gwas_cfg(pop, tmp_path / "o4"))
    assert (tmp_path / "o4" / "full_table.kinship").exists()
    assert not os.path.exists(cache)
    assert "kinship cache beside the table failed" in \
        (tmp_path / "o4" / "log_file").read_text()
    for r in (r2, r3, r4):
        assert r.thresholds == r1.thresholds
        assert r.pass_5per == r1.pass_5per


def test_dont_remove_intermediates(tmp_path, pop):
    keep = pgwas.run_gwas(gwas_cfg(pop, tmp_path / "keep",
                                   remove_intermediates=False))
    drop = pgwas.run_gwas(gwas_cfg(pop, tmp_path / "drop"))
    k, d = tmp_path / "keep" / "kmers", tmp_path / "drop" / "kmers"
    for j in range(21):
        name = "phenotype_value" if j == 0 else f"P{j}"
        for ext in (".bed", ".bim", ".fam"):
            assert (k / f"pheno.{j}.{name}{ext}").exists()
            assert (d / f"pheno.{j}.{name}{ext}").exists() == (j == 0)
        assert (k / "output" / f"{name}.assoc.txt").exists()
    assert not (d / "output" / "P1.assoc.txt").exists()
    raw = gzip.decompress((d / "output" / "phenotype_value.assoc.txt.gz")
                          .read_bytes())
    assert raw == (k / "output" / "phenotype_value.assoc.txt").read_bytes()
    assert keep.thresholds == drop.thresholds


def test_checkpoints_certify_and_device32(tmp_path, pop, monkeypatch):
    """checkpoint_base writes <base>.kin and <base>.scan; certify_topk and
    the score precision reach the scan; lmm_backend="device32" runs float32
    on the CPU when asked, its p-values close to host64's."""
    seen = {}
    orig = pscan.associate

    def spy(*a, **kw):
        seen.update(kw)
        return orig(*a, **kw)
    monkeypatch.setattr(pgwas.scan_mod, "associate", spy)
    ck = str(tmp_path / "ck")
    if os.path.exists(pop["base"] + ".kinship"):
        os.remove(pop["base"] + ".kinship")
    r32 = pgwas.run_gwas(gwas_cfg(
        pop, tmp_path / "d32", lmm_backend="device32", certify_topk=True,
        score_precision="highest", checkpoint_base=ck, checkpoint_every=1))
    assert seen["certify_topk"] and seen["score_precision"] == "highest"
    assert seen["checkpoint_path"] == ck + ".scan"
    assert os.path.exists(ck + ".scan.npz") and os.path.exists(ck + ".kin.npz")
    assert json.loads((tmp_path / "d32" / "summary.json").read_text())[
        "lmm_backend"] == "device32"
    r64 = pgwas.run_gwas(gwas_cfg(pop, tmp_path / "d64", certify_topk=True,
                                  score_precision="highest"))
    a, b = (np.array([r.best_pvals[k] for k in sorted(r.best_pvals)])
            for r in (r32, r64))
    np.testing.assert_allclose(a, b, atol=5e-2)


def test_lmm_backend_rule():
    """auto picks device32 only on the card above 2e8 variant-tests x
    samples (kmersgwas_tpu/pipeline/gwas.py:328-332)."""
    import torch
    cfg = pgwas.GWASConfig("p", "t", "o", 31)
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert pgwas._lmm_backend(cfg, cuda, 101 * 10001, 1008) == "device32"
    assert pgwas._lmm_backend(cfg, cuda, 1000, 1008) == "host64"
    assert pgwas._lmm_backend(cfg, cpu, 101 * 10001, 1008) == "host64"
    cfg.lmm_backend = "host64"
    assert pgwas._lmm_backend(cfg, cuda, 101 * 10001, 1008) == "host64"
    assert cfg.device == "cuda"


@pytest.mark.parametrize("flags", [
    ["--devices", "2"],
])
def test_cli_gwas_refuses_what_is_not_ported(tmp_path, pop, flags,
                                             monkeypatch):
    """Nothing of `gwas` is left unported: `--devices 2`, refused until
    the port had a device mesh, now runs on 2 cpu shards to one device's
    artifacts (each run on its own copy of the table, as gwas caches its
    kinship beside it); with "cuda" and no card it is refused before any
    output."""
    trees = []
    for tag, extra in (("one", []), ("mesh", flags)):
        table = str(tmp_path / f"{tag}_pop")
        for ext in (".table", ".names"):
            shutil.copy(pop["base"] + ext, table + ext)
        port_cli(["gwas", "--pheno", str(pop["pheno_path"]),
                  "--kmers_table", table, "--outdir", str(tmp_path / tag),
                  "-l", str(K), "-k", "30", "--permutations", "8", "--mac",
                  "2", "--batch_size", "500", "--min_data_points", "10",
                  "--lmm_backend", "host64", "--device", "cpu"] + extra)
        trees.append({f: v for f, v in read_tree(tmp_path / tag).items()
                      if f not in ("log_file", "summary.json")})
    assert trees[0] == trees[1] and "kmers/threshold_5per" in trees[0]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        port_cli(["gwas", "--pheno", str(pop["pheno_path"]),
                  "--kmers_table", pop["base"], "--outdir",
                  str(tmp_path / "out"), "-l", str(K), "--device", "cuda"]
                 + flags)
    assert not (tmp_path / "out").exists()


@pytest.fixture(scope="module")
def snp_bed(tmp_path_factory, pop):
    """A 200-SNP bed over the population's accessions (hom, het and
    missing calls), SNP 17 planted as the causal k-mer's pattern."""
    rng = np.random.default_rng(23)
    d = random_dubits(rng, 200, len(pop["names"]))
    d[17] = np.where(pop["presence"][pop["causal_idx"]], 3, 0)
    return write_bed(str(tmp_path_factory.mktemp("bed") / "snps"), d,
                     pop["names"])


def split_tree(files):
    snps = {f: v for f, v in files.items() if f.startswith("snps/")}
    return {f: v for f, v in files.items() if f not in snps}, snps


@pytest.mark.parametrize("flags", [
    ["--snp_matrix", "snps"],
    ["--snp_matrix", "snps", "--run_on_snps_one_step"],
    ["--snp_matrix", "snps", "--run_on_snps_two_steps"],
    ["--snp_matrix", "snps", "--kinship_snps"],
    ["--dont_run_on_kmers"],
])
def test_cli_gwas_snp_flags_match_jax_cli(tmp_path, pop, snp_bed,
                                          shared_transform, capsys, flags):
    """Each SNP flag set runs in both CLIs, each on its own copy of the
    bed (the SNP kinship is cached beside it): the same files, the k-mer
    artifacts as in test_cli_gwas_matches_jax_cli, the snps/ ones as in
    tests/test_torch_snps.py, the SNP kinship within atol 1e-12."""
    lines, trees = {}, {}
    for pkg, cli, extra in (("jax", jax_cli, []),
                            ("port", port_cli, ["--device", "cpu"])):
        (tmp_path / pkg).mkdir()
        base = str(tmp_path / pkg / "snps")
        for ext in (".bed", ".bim", ".fam"):
            shutil.copy(snp_bed + ext, base + ext)
        cli(["gwas", "--outdir", str(tmp_path / f"out_{pkg}"), "--pheno",
             str(pop["pheno_path"]), "--kmers_table", pop["base"], "-l",
             str(K), "-k", "30", "--permutations", "10", "--mac", "2",
             "--min_data_points", "10", "--batch_size", "500",
             "--snps_number", "40"]
            + [base if a == "snps" else a for a in flags] + extra)
        lines[pkg] = capsys.readouterr().out.strip()
        trees[pkg] = read_tree(tmp_path / f"out_{pkg}")
    (got, got_snps), (want, want_snps) = (split_tree(trees[k])
                                          for k in ("port", "jax"))
    assert bool(want_snps) == any("run_on_snps" in f for f in flags)
    if want_snps:
        assert_same_snp_artifacts(got_snps, want_snps)
    assert not got_snps or want_snps
    if "--kinship_snps" in flags:
        np.testing.assert_allclose(
            np.loadtxt(io.BytesIO(got.pop("pheno.kinship"))),
            np.loadtxt(io.BytesIO(want.pop("pheno.kinship"))), rtol=0,
            atol=1e-12)
        assert os.path.exists(tmp_path / "port" / "snps.kinship")
    if "--dont_run_on_kmers" in flags:
        assert sorted(got) == sorted(want) and "kmers/best_pvals" not in want
        for f in want:
            assert f == "log_file" or got[f] == want[f], f
    else:
        # on the SNP kinship, which the packages round differently, the
        # k-mers' l_mle wanders as on doses (tests/test_torch_snps.py)
        assert_same_artifacts(got, want, assert_lmm_fields
                              if "--kinship_snps" in flags
                              else assert_lmm_close)
    (g_th, g_rest), (w_th, w_rest) = (
        ln.split(" ", 1) for ln in (lines["port"], lines["jax"]))
    assert g_rest == w_rest
    if w_th == "threshold_5per=n/a":
        assert g_th == w_th
    else:
        assert math.isclose(float(g_th.split("=")[1]),
                            float(w_th.split("=")[1]), rel_tol=1e-9)


@pytest.mark.parametrize("run_snps,run_kmers", [("two_steps", False),
                                                ("one_step", True)])
def test_run_gwas_snp_arm_matches_jax(tmp_path, pop, snp_bed,
                                      shared_transform, run_snps,
                                      run_kmers):
    """run_gwas with kinship_snps and the SNP arm, in both packages on
    their own copies of the bed: the same GWASResult thresholds and
    best_pvals, the same artifacts; the port's SNP stages timed."""
    res = {}
    for pkg, mod, extra in (("jax", jgwas, {}), ("port", pgwas,
                                                  {"device": "cpu"})):
        (tmp_path / pkg).mkdir()
        base = str(tmp_path / pkg / "snps")
        for ext in (".bed", ".bim", ".fam"):
            shutil.copy(snp_bed + ext, base + ext)
        res[pkg] = mod.run_gwas(mod.GWASConfig(
            outdir=str(tmp_path / f"out_{pkg}"), snps_matrix=base,
            run_snps=run_snps, kinship_snps=True, run_kmers=run_kmers,
            n_snps=40, remove_intermediates=False,
            pheno_path=str(pop["pheno_path"]), kmers_table=pop["base"],
            **dict(KW, n_permutations=10), **extra))
    got, want = res["port"], res["jax"]
    for key, v in want.thresholds.items():
        assert math.isclose(got.thresholds[key], v, rel_tol=1e-9)
    assert list(got.best_pvals) == list(want.best_pvals)
    np.testing.assert_allclose(list(got.best_pvals.values()),
                               list(want.best_pvals.values()), rtol=1e-9)
    (g, g_snps), (w, w_snps) = (split_tree(read_tree(tmp_path / f"out_{k}"))
                                for k in ("port", "jax"))
    assert_same_snp_artifacts(g_snps, w_snps)
    np.testing.assert_allclose(np.loadtxt(io.BytesIO(g.pop("pheno.kinship"))),
                               np.loadtxt(io.BytesIO(w.pop("pheno.kinship"))),
                               rtol=0, atol=1e-12)
    if run_kmers:
        assert_same_artifacts(g, w, assert_lmm_fields)
    else:
        assert sorted(g) == sorted(w) and "summary.json" not in w
    stages = {"snp_kinship", "snps.planes", "snps.scores", "snps.lmm",
              "snps.artifacts"}
    assert stages <= set(got.stage_seconds)
    # the SNP kinship was cached beside the bed, and is read back
    again = pgwas.run_gwas(pgwas.GWASConfig(
        outdir=str(tmp_path / "again"), snps_matrix=str(tmp_path / "port" /
                                                         "snps"),
        run_snps=run_snps, kinship_snps=True, run_kmers=False, n_snps=40,
        pheno_path=str(pop["pheno_path"]), kmers_table=pop["base"],
        device="cpu", **dict(KW, n_permutations=10)))
    assert "snp_kinship" not in again.stage_seconds
    assert "Using kinship calculated on SNPs" in \
        (tmp_path / "again" / "log_file").read_text()
    assert_same_snp_artifacts(split_tree(read_tree(tmp_path / "again"))[1],
                              g_snps)
