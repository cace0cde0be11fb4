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


def select_by_lookup(per_pheno, kmer_of_row, pa_of_row, pheno_values,
                     n_used, n_top, first_phenotype_top, certify_topk):
    """select_candidates as it was before slots: every column's rows looked
    up in the fetched rows by RowLookup.take (a binary search a row)."""
    scores_out, rows_out, kmers_out = [], [], []
    certified = [] if certify_topk else None
    yv = np.asarray(pheno_values, np.float32).astype(np.float64)
    ysums = yv.sum(axis=0)
    for j, (sc, rw) in enumerate(per_pheno):
        cap = first_phenotype_top if (j == 0 and first_phenotype_top) else n_top
        if certify_topk:
            pa = np.asarray(pa_of_row.take(rw))
            bits = np.unpackbits(np.ascontiguousarray(pa).view(np.uint8),
                                 axis=1, bitorder="little"
                                 )[:, :n_used].astype(np.float64)
            n1 = bits.sum(axis=1)
            r_ = n_used * (bits @ yv[:, j]) - n1 * ysums[j]
            denom = n_used * n1 - n1 * n1
            with np.errstate(divide="ignore", invalid="ignore"):
                s_ex = np.where(denom > 0, r_ * r_ / denom, 0.0)
            order, cert = pscan.certify_column(sc, rw, s_ex, cap)
            certified.append(bool(cert))
            sc, rw = s_ex[order], np.asarray(rw)[order]
        else:
            sc, rw = sc[:cap], rw[:cap]
        scores_out.append(sc)
        rows_out.append(rw)
        kmers_out.append(np.asarray(kmer_of_row.take(rw), dtype=np.uint64))
    return scores_out, rows_out, kmers_out, certified


def scan_candidates(seed, lengths, pool, n_used=70):
    """Per column (scores descending, distinct int64 rows) as a finished
    scan hands them over, each column's rows drawn from range(pool), so
    rows repeat across columns; the fetched rows' codes and packed
    presence words; phenotypes."""
    rng = np.random.default_rng(seed)
    per_pheno = [(np.sort(rng.normal(size=m))[::-1].astype(np.float64),
                  rng.choice(pool, size=m, replace=False).astype(np.int64))
                 for m in lengths]
    rows = np.unique(np.concatenate([rw for _, rw in per_pheno]))
    n64 = (n_used + 63) // 64
    pa = rng.integers(0, 2**63, size=(len(rows), n64), dtype=np.int64)
    pa[:, -1] &= (1 << (n_used - 64 * (n64 - 1))) - 1
    kmer_of_row = pscan.RowLookup(rows, rng.integers(
        0, 2**62, size=len(rows), dtype=np.int64).astype(np.uint64))
    pa_of_row = pscan.RowLookup(rows, pa.view(np.uint64))
    y = dyadic(seed, n_used, len(lengths))
    return per_pheno, kmer_of_row, pa_of_row, y


@pytest.mark.parametrize("lengths,n_top,first,certify", [
    ([40, 40, 40, 40, 40], 30, None, False),      # rows repeated across columns
    ([40, 0, 40, 25], 30, None, False),           # an empty column
    ([0, 0, 0], 30, None, False),                 # every column empty
    ([60, 40, 40], 20, 50, False),                # first_phenotype_top
    ([40, 40, 0, 33], 25, None, True),            # certify_topk
], ids=["repeated", "empty_column", "all_empty", "first_top", "certify"])
def test_winners_resolved_by_slot_equal_the_lookup(lengths, n_top, first,
                                                    certify):
    """resolve_winners' rows are np.unique's and its slots RowLookup.take's
    positions; select_candidates gathering by slot gives, byte for byte,
    what looking every row up gave."""
    per_pheno, kmer_of_row, pa_of_row, y = scan_candidates(
        len(lengths) + n_top, lengths, pool=90)
    all_rows, slots = pscan.resolve_winners(per_pheno, "cpu")
    cols = [rw for _, rw in per_pheno]
    want = np.unique(np.concatenate(cols)) if sum(lengths) else np.empty(
        0, np.int64)
    assert all_rows.dtype == np.int64
    np.testing.assert_array_equal(all_rows, want)
    assert len(slots) == len(cols)
    positions = pscan.RowLookup(want, np.arange(len(want), dtype=np.int64))
    for slot, rw in zip(slots, cols):
        assert slot.dtype == np.int64
        np.testing.assert_array_equal(slot, positions.take(rw))
    args = (kmer_of_row, pa_of_row, y, 70, n_top, first, certify)
    got = pscan.select_candidates(per_pheno, slots, *args)
    ref = select_by_lookup(per_pheno, *args)
    assert got[3] == ref[3]
    assert (got[3] is not None) == certify
    for got_cols, ref_cols in zip(got[:3], ref[:3]):
        assert len(got_cols) == len(ref_cols) == len(lengths)
        for a, b in zip(got_cols, ref_cols):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()
