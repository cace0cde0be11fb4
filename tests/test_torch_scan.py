"""The port's association scan (kmersgwas_tpu_torch.pipeline.scan and its
CLI) against the JAX package on the CPU, on test_pipeline's synthetic
populations: same rows, scores and k-mers on both routes; checkpoints that
resume across the two packages; byte-identical dtables, PLINK exports and
CLI outputs."""
import filecmp
import os

import numpy as np
import pytest

from kmersgwas_tpu.cli.__main__ import main as jax_cli
from kmersgwas_tpu.core import dtable as jdtable
from kmersgwas_tpu.core import formats
from kmersgwas_tpu.pipeline import checkpoint as jckpt
from kmersgwas_tpu.pipeline import scan as jscan
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.core import dtable as pdtable
from kmersgwas_tpu_torch.pipeline import checkpoint as pckpt
from kmersgwas_tpu_torch.pipeline import scan as pscan

from test_pipeline import K, build_population

KW = dict(kmer_len=K, n_top=25, maf=0.05, mac=2, batch_size=97)


def dyadic(seed, n, p):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(-8, 8, size=(n, p)) * 8) / 8).astype(
        np.float32)


def assert_same(a, b, exact=True):
    assert a.n_tested == b.n_tested and a.n_patterns == b.n_patterns
    assert a.certified == b.certified
    for j in range(len(a.names)):
        np.testing.assert_array_equal(a.rows[j], b.rows[j])
        np.testing.assert_array_equal(a.kmers[j], b.kmers[j])
        if exact:
            np.testing.assert_array_equal(a.scores[j], b.scores[j])
        else:
            np.testing.assert_allclose(a.scores[j], b.scores[j], rtol=1e-5)


@pytest.mark.parametrize("route,extra", [
    ("table", {}),
    ("dtable", {}),
    ("table", dict(certify_topk=True, first_phenotype_top=40,
                   count_patterns=True)),
    ("dtable", dict(certify_topk=True, count_patterns=True)),
])
def test_associate_matches_jax(tmp_path, route, extra):
    pop = build_population(tmp_path)
    y = dyadic(1, len(pop["names"]), 4)
    kw = dict(KW, **extra)
    if route == "dtable":
        kw["dtable_cache"] = str(tmp_path / "pop.dtable")
    want = jscan.associate(pop["base"], pop["names"], y, list("abcd"), **kw)
    got = pscan.associate(pop["base"], pop["names"], y, list("abcd"),
                          device="cpu", **kw)
    assert_same(got, want)
    assert got.steps["narrow"] + got.steps["wide"] + got.steps[
        "fallback"] == len(got.steps["step_s"])


def test_associate_gaussian_highest_matches_jax(tmp_path):
    """Gaussian phenotypes: the port at precision "highest" selects the
    reference's rows, with scores within rtol 1e-5 (f32 sums in another
    order); certify_topk then re-scores both in f64."""
    pop = build_population(tmp_path, seed=13)
    y = np.random.default_rng(3).normal(size=(len(pop["names"]), 3))
    want = jscan.associate(pop["base"], pop["names"], y, list("abc"), **KW)
    got = pscan.associate(pop["base"], pop["names"], y, list("abc"),
                          device="cpu", score_precision="highest", **KW)
    assert_same(got, want, exact=False)
    got_c = pscan.associate(pop["base"], pop["names"], y, list("abc"),
                            device="cpu", certify_topk=True, **KW)
    assert got_c.certified == [True] * 3
    for j in range(3):
        assert set(got_c.rows[j].tolist()) == set(want.rows[j].tolist())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_checkpoint_resumes_across_packages(tmp_path, writer):
    """A scan that crashed mid-stream under one package resumes under the
    other from the exact dtable position and ends equal to an unbroken
    scan."""
    pop = build_population(tmp_path, n_samples=16, n_kmers=400)
    y = dyadic(8, 16, 2)
    kw = dict(KW, n_top=20, batch_size=50,
              dtable_cache=str(tmp_path / "pop.dtable"))
    full = pscan.associate(pop["base"], pop["names"], y, ["a", "b"],
                           device="cpu", **kw)
    ck = str(tmp_path / "ck")

    class Boom(RuntimeError):
        pass

    calls = []

    def crash_after_3(_r):
        calls.append(_r)
        if len(calls) == 3:
            raise Boom()

    first, second = ((jscan.associate, pscan.associate) if writer == "jax"
                     else (pscan.associate, jscan.associate))
    dev = lambda fn: {"device": "cpu"} if fn is pscan.associate else {}
    with pytest.raises(Boom):
        first(pop["base"], pop["names"], y, ["a", "b"], checkpoint_path=ck,
              checkpoint_every=1, progress=crash_after_3, **dev(first), **kw)
    loader = pckpt if writer == "jax" else jckpt
    st = loader.load_scan_state(ck)
    assert st is not None and st[3] == "dtable"
    assert 0 < st[1] < full.n_tested
    res = second(pop["base"], pop["names"], y, ["a", "b"],
                 checkpoint_path=ck, checkpoint_every=1, **dev(second), **kw)
    assert_same(res, full)


def test_dtable_builders_write_identical_bytes(tmp_path):
    pop = build_population(tmp_path, n_samples=20, n_kmers=300)
    sub = pop["names"][2:17]
    for mod, name in ((jdtable, "j.dtable"), (pdtable, "p.dtable")):
        mod.build_dtable(pop["base"], str(tmp_path / name),
                         names_to_use=sub, min_count=2, batch_rows=64)
    assert filecmp.cmp(tmp_path / "j.dtable", tmp_path / "p.dtable",
                       shallow=False)
    dt = pdtable.DTableReader(str(tmp_path / "j.dtable"))
    assert dt.matches(min_count=2, n_used=15,
                      names_hash=jdtable.names_hash_of(sub))


def test_export_plink_identical_bytes(tmp_path):
    pop = build_population(tmp_path, n_samples=9, n_kmers=100)
    y = dyadic(3, 9, 1)
    kw = dict(kmer_len=K, n_top=12, maf=0.0, mac=1, batch_size=1000)
    bases = []
    for mod, extra in ((jscan, {}), (pscan, {"device": "cpu"})):
        res = mod.associate(pop["base"], pop["names"], y, ["p"], **kw,
                            **extra)
        base = str(tmp_path / mod.__name__.split(".")[0])
        mod.export_plink(res, 9, K, [base])
        bases.append(base)
    for ext in (".bed", ".bim"):
        assert filecmp.cmp(bases[0] + ext, bases[1] + ext, shallow=False)


def test_cli_associate_identical_outputs(tmp_path):
    pop = build_population(tmp_path, n_samples=24, n_kmers=400, seed=5)
    y = dyadic(9, 24, 2).astype(np.float64)
    pheno = str(tmp_path / "pheno.tsv")
    formats.write_phenotypes(pheno, formats.PhenotypeTable(
        names=["a", "b"], accessions=pop["names"], values=y))
    args = ["associate", "-p", pheno, "-b", "out", "--kmers_table",
            pop["base"], "-n", "30", "--kmer_len", str(K), "--mac", "2",
            "--batch_size", "64", "--pattern_counter", "--kmers_scores"]
    for name, cli, extra in (("jax", jax_cli, []),
                             ("port", port_cli, ["--device", "cpu"])):
        os.makedirs(tmp_path / name)
        cli(args + ["-o", str(tmp_path / name)] + extra)
    files = sorted(os.listdir(tmp_path / "jax"))
    assert files == sorted(os.listdir(tmp_path / "port"))
    assert any(f.endswith(".bed") for f in files)
    match, mismatch, errors = filecmp.cmpfiles(
        tmp_path / "jax", tmp_path / "port", files, shallow=False)
    assert not mismatch and not errors, mismatch


def test_associate_refuses_mesh_and_missing_card(tmp_path, monkeypatch):
    """A mesh is accepted (2 cpu shards give the single-device result; a
    mesh of another device kind than `device` raises); "cuda" without a
    card raises."""
    import torch
    from kmersgwas_tpu_torch.parallel import sharding
    pop = build_population(tmp_path, n_samples=10, n_kmers=60)
    y = dyadic(2, 10, 1)
    got = pscan.associate(pop["base"], pop["names"], y, ["p"], device="cpu",
                          mesh=sharding.make_mesh(["cpu", "cpu"]), **KW)
    assert_same(got, pscan.associate(pop["base"], pop["names"], y, ["p"],
                                     device="cpu", **KW))
    with pytest.raises(ValueError, match="disagree"):
        pscan.associate(pop["base"], pop["names"], y, ["p"], device="cuda"
                        if torch.cuda.is_available() else "cpu",
                        mesh=sharding.Mesh((torch.device("meta"),)), **KW)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        pscan.associate(pop["base"], pop["names"], y, ["p"], device="cuda",
                        **KW)
