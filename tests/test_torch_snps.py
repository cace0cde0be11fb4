"""The port's SNP arm (kmersgwas_tpu_torch.snps, pipeline/snp_gwas and the
CLI `kinship-bed` / `associate-snps`) against the JAX package's on the
CPU, on random PLINK beds made with numpy from a seed.

Tolerances: the planes, their scalars, the prefilter's indices and every
exported byte are equal. GRAMMAR scores are float32 products in another
order than XLA's: equal on dyadic phenotypes (multiples of 1/32, where
every partial sum is exact), within rtol 1e-6 on Gaussian ones, plus 1e-5
of the largest score where a score near 0 is a difference of large float32
sums (observed: 9e-7 of the largest). The SNP
kinship folds four products into one (snps/kinship.py), so it agrees to
rounding: atol 1e-12, and `kinship-bed`'s 6-digit stdout byte for byte.
The exact LMM's p_lrt is parsed and held at rtol 1e-6, its l_mle at rtol
2.3e-4: lambda is the argmax of a profile likelihood that is flat to its
rounding near the optimum, where the golden-section search follows
rounding noise in either package (ROADMAP §C, known item 4; 5.5e-6 here,
on mean-imputed doses). Every other field of the assoc tables is equal.
"""
import math
import os

import numpy as np
import pytest
import torch

from kmersgwas_tpu.cli.__main__ import main as jax_cli
from kmersgwas_tpu.core import formats as jformats
from kmersgwas_tpu.pipeline import snp_gwas as jsnp_gwas
from kmersgwas_tpu.snps import assoc as jassoc
from kmersgwas_tpu.snps import bed as jbed
from kmersgwas_tpu.snps import kinship as jkinship
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.core import formats as pformats
from kmersgwas_tpu_torch.pipeline import snp_gwas as psnp_gwas
from kmersgwas_tpu_torch.snps import assoc as passoc
from kmersgwas_tpu_torch.snps import bed as pbed
from kmersgwas_tpu_torch.snps import kinship as pkinship
from kmersgwas_tpu_torch.stats import lmm as plmm

CPU = "cpu"


def write_bed(base, dubits, names):
    """A PLINK bed/bim/fam of (M, n) dubits {0: hom ref, 1: missing,
    2: het, 3: hom alt} over samples `names`."""
    m, n = dubits.shape
    body = np.zeros((m, (n + 3) // 4), dtype=np.uint8)
    for j in range(n):
        body[:, j // 4] |= dubits[:, j] << ((j % 4) * 2)
    with open(base + ".bed", "wb") as f:
        f.write(jformats.PLINK_BED_MAGIC)
        body.tofile(f)
    with open(base + ".bim", "w") as f:
        for i in range(m):
            f.write(f"{1 + i % 3}\tsnp{i}\t0\t{100 * i}\tA\tG\n")
    jformats.write_fam(base + ".fam", names, np.zeros(n))
    return base


def random_dubits(rng, m, n, missing=0.05, het=0.1, dup=0):
    """Per-SNP alt frequency uniform in [0.02, 0.98], `het` of the calls
    heterozygous and `missing` missing; the last `dup` rows copy earlier
    ones, so GRAMMAR scores tie."""
    u = rng.random((m, n))
    alt = rng.uniform(0.02, 0.98, size=(m, 1))
    d = np.where(u < alt, 3, 0).astype(np.uint8)
    d[rng.random((m, n)) < het] = 2
    d[rng.random((m, n)) < missing] = 1
    if dup:
        d[m - dup:] = d[rng.integers(0, m - dup, size=dup)]
    return d


def make_bed(tmp_path, seed, m=300, n=70, name="snps", **kw):
    rng = np.random.default_rng(seed)
    names = [f"acc{i:03d}" for i in range(n)]
    d = random_dubits(rng, m, n, **kw)
    return write_bed(str(tmp_path / name), d, names), names, d


def dyadic(rng, shape):
    return np.clip(np.round(rng.normal(size=shape) * 32), -255, 255) / 32


def planes_np(p):
    return {f: getattr(p, f).numpy().view(np.uint32)
            for f in ("presence", "nonmiss", "het")} | {
        f: getattr(p, f).numpy() for f in ("s_gi", "s_gi2", "total")}


@pytest.mark.parametrize("subset", [None, "permuted", "first"])
@pytest.mark.parametrize("chunk", [7, 1 << 16])
def test_bed_planes_equal_jax(tmp_path, subset, chunk):
    base, names, _ = make_bed(tmp_path, 1, m=130, n=150)
    rng = np.random.default_rng(2)
    use = None if subset is None else \
        [names[i] for i in rng.permutation(150)[:100]] \
        if subset == "permuted" else names[:33]
    want = jbed.load_bed_planes(base, use)
    got = pbed.load_bed_planes(base, use, device=CPU, chunk=chunk)
    assert (got.n_samples, got.n_pad) == (want.n_samples, want.n_pad)
    for f, v in planes_np(got).items():
        w = getattr(want, f)
        assert v.dtype == w.dtype and np.array_equal(v, w), f


def test_bed_missing_sample_and_bad_files(tmp_path):
    base, names, _ = make_bed(tmp_path, 3, m=20, n=9)
    with pytest.raises(ValueError, match="sample missing from fam file: "
                       "nobody") as e:
        pbed.load_bed_planes(base, names[:3] + ["nobody"], device=CPU)
    with pytest.raises(ValueError) as ej:
        jbed.load_bed_planes(base, names[:3] + ["nobody"])
    assert str(e.value) == str(ej.value)
    with open(base + ".bed", "ab") as f:
        f.write(b"\0")                          # not whole SNP rows
    with pytest.raises(ValueError, match="whole number"):
        pformats.read_bed_header(base)
    with open(base + ".bed", "r+b") as f:
        f.write(b"XYZ")
    with pytest.raises(ValueError, match="magic"):
        pbed.load_bed_planes(base, device=CPU)


def test_iter_bed_rows_equals_read_bed(tmp_path):
    base, names, d = make_bed(tmp_path, 4, m=45, n=13)
    got = [pbed.decode_dubits(torch.from_numpy(r), len(names)).numpy()
           for _, r in pformats.iter_bed_rows(base, 8)]
    assert [s for s, _ in pformats.iter_bed_rows(base, 8)] == \
        list(range(0, 45, 8))
    assert np.array_equal(np.concatenate(got), d)
    assert np.array_equal(np.concatenate(got), pformats.read_bed(base)[1])


@pytest.mark.parametrize("gaussian", [False, True])
def test_snp_scores_match_jax(tmp_path, gaussian):
    base, names, _ = make_bed(tmp_path, 5, m=400, n=90)
    rng = np.random.default_rng(6)
    y = (rng.normal(size=(90, 4)) if gaussian else dyadic(rng, (90, 4)))
    want_idx, want = jassoc.most_associated_snps(
        jbed.load_bed_planes(base), y.astype(np.float32), 25, 0.05, 3)
    got_idx, got = passoc.most_associated_snps(
        pbed.load_bed_planes(base, device=CPU), y.astype(np.float32), 25,
        0.05, 3)
    got = got.numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert (want == 0).sum() > 0            # the mac mask is exercised
    if gaussian:
        # near-zero scores are r^2 / denom with r = N yigi - S_gi ysum a
        # float32 difference of large sums: they agree to float32's
        # resolution of the column's largest terms, not to rtol
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-5 * want.max())
    else:
        assert np.array_equal(got, want)
        for a, b in zip(got_idx, want_idx):
            assert np.array_equal(a, b)


def test_prefilter_ties_keep_the_lower_index(tmp_path):
    """Duplicated SNP rows tie exactly; on dyadic phenotypes the
    selection equals the JAX package's stable order, also at a cut through
    a run of ties, and with more SNPs asked for than there are."""
    base, names, d = make_bed(tmp_path, 7, m=240, n=64, dup=120, het=0.0,
                              missing=0.0)
    rng = np.random.default_rng(8)
    y = dyadic(rng, (64, 6)).astype(np.float32)
    planes = pbed.load_bed_planes(base, device=CPU)
    jplanes = jbed.load_bed_planes(base)
    for n_best in (1, 17, 60, 239, 500):
        want, ws = jassoc.most_associated_snps(jplanes, y, n_best, 0.0, 1)
        got, _ = passoc.most_associated_snps(planes, y, n_best, 0.0, 1)
        for a, b in zip(got, want):
            assert np.array_equal(a, b), n_best
    col = ws[:, 0]
    assert len(np.unique(col)) < len(col) - 100     # ties do occur


def test_export_and_associate_snps_cli_bytes(tmp_path):
    base, names, _ = make_bed(tmp_path, 9, m=200, n=50)
    sel = [np.array([3, 7, 20, 199]), np.array([0]), np.array([], np.int64)]
    for pkg, mod in (("jax", jassoc), ("port", passoc)):
        mod.export_selected_snps(base, [str(tmp_path / f"{pkg}.{i}")
                                        for i in range(3)], sel)
    for i in range(3):
        for ext in (".bed", ".bim"):
            assert (tmp_path / f"port.{i}{ext}").read_bytes() == \
                (tmp_path / f"jax.{i}{ext}").read_bytes()
    rng = np.random.default_rng(10)
    pheno = tmp_path / "p.tsv"
    jformats.write_phenotypes(pheno, jformats.PhenotypeTable(
        ["phenotype_value", "P1", "P2"], names[::-1][:45],
        dyadic(rng, (45, 3))))
    for pkg, cli, extra in (("jax", jax_cli, []),
                            ("port", port_cli, ["--device", CPU])):
        cli(["associate-snps", str(pheno), base, str(tmp_path / f"a_{pkg}"),
             "30", "0.05", "2"] + extra)
    for nm in ("phenotype_value", "P1", "P2"):
        for ext in (".bed", ".bim"):
            got = (tmp_path / f"a_port.{nm}{ext}").read_bytes()
            assert got == (tmp_path / f"a_jax.{nm}{ext}").read_bytes()
    assert len((tmp_path / "a_port.P1.bim").read_text().splitlines()) == 30


def test_emma_kinship_from_bed_and_cli(tmp_path, capsys):
    base, names, _ = make_bed(tmp_path, 11, m=333, n=41, missing=0.1,
                              het=0.15)
    # a SNP with no observed genotype adds nothing
    with open(base + ".bed", "ab") as f:
        f.write(bytes([0x55]) * ((41 + 3) // 4))
    with open(base + ".bim", "a") as f:
        f.write("1\tsnp_missing\t0\t1\tA\tG\n")
    want = jkinship.emma_kinship_from_bed(base)
    for chunk in (5, 1 << 15):
        got = pkinship.emma_kinship_from_bed(base, chunk, device=CPU)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert np.array_equal(np.diag(got), np.ones(41))
        assert np.array_equal(got, got.T)
    jax_cli(["kinship-bed", base])
    want_out = capsys.readouterr().out
    port_cli(["kinship-bed", base, "--device", CPU])
    assert capsys.readouterr().out == want_out
    write_bed(base, np.ones((3, 41), np.uint8), names)
    with pytest.raises(ValueError, match="no SNPs with observed"):
        pkinship.emma_kinship_from_bed(base, device=CPU)


def arm_inputs(tmp_path, seed, n=60, m=250, n_perm=8):
    """A bed with a planted causal SNP, the kinship's eigensystem, and
    untransformed / dyadic transformed phenotype tables over its samples
    (a subset, in another order than the .fam's)."""
    base, names, d = make_bed(tmp_path, seed, m=m, n=n + 5)
    rng = np.random.default_rng(seed + 1)
    used = [names[i] for i in rng.permutation(n + 5)[:n]]
    cols = [names.index(a) for a in used]
    dose = np.where(d == 3, 1.0, np.where(d == 2, 0.5, 0.0))[:, cols]
    G0 = rng.normal(size=(n, 2 * n))
    K = G0 @ G0.T / (2 * n)
    K /= np.diag(K).mean()
    w, U = np.linalg.eigh(K)
    y = rng.normal(size=(n, 1 + n_perm))
    y[:, 0] += 2.0 * dose[17]
    names_p = ["phenotype_value"] + [f"P{i}" for i in range(1, n_perm + 1)]
    return base, used, y, dyadic(rng, y.shape), names_p, w, U


def read_tree(out):
    files = {}
    for root, _, fs in os.walk(out):
        for f in fs:
            path = os.path.join(root, f)
            with open(path, "rb") as fh:
                files[os.path.relpath(path, out)] = fh.read()
    return files


def assert_lmm_fields(got, want):
    """(l_mle, p_lrt) strings: p_lrt at rtol 1e-6, l_mle = 10^log10
    lambda at rtol 2.3e-4, ln(10) times the atol 1e-4 at which
    tests/test_torch_stats.py holds log10 lambda (module docstring)."""
    (gl, gp), (wl, wp) = ([float(v) for v in x] for x in (got, want))
    assert math.isclose(gp, wp, rel_tol=1e-6), (got, want)
    assert math.isclose(gl, wl, rel_tol=2.3e-4), (got, want)


def assert_same_snp_artifacts(got, want):
    """snps/: assoc tables and pass files equal but l_mle and p_lrt
    (rtol 1e-6), best_pvals at rtol 1e-9, every other file
    byte-identical."""
    got = {f: v for f, v in got.items() if f.startswith("snps/")}
    want = {f: v for f, v in want.items() if f.startswith("snps/")}
    assert sorted(got) == sorted(want) and "snps/best_pvals" in want
    for f in want:
        if ".assoc.txt" in f or "pass_threshold" in f:
            g, w = (x[f].decode().splitlines() for x in (got, want))
            assert len(g) == len(w), f
            if ".assoc.txt" in f:
                assert g[0] == w[0]
                g, w = g[1:], w[1:]
            for a, b in zip(g, w):
                a, b = a.split("\t"), b.split("\t")
                assert a[:7] == b[:7], f
                assert_lmm_fields(a[7:], b[7:])
        elif f == "snps/best_pvals":
            g, w = (dict(ln.split("\t") for ln in x[f].decode()
                         .splitlines()) for x in (got, want))
            assert list(g) == list(w)
            np.testing.assert_allclose([float(v) for v in g.values()],
                                       [float(v) for v in w.values()],
                                       rtol=1e-9)
        else:
            assert got[f] == want[f], f


@pytest.mark.parametrize("mode", ["one_step", "two_steps"])
def test_run_snp_arm_matches_jax(tmp_path, mode):
    base, used, y, yt, names, w, U = arm_inputs(tmp_path, 12)
    kw = dict(mode=mode, n_snps=20, maf=0.05, mac=3, n_permutations=8,
              lmm_grid=32, lmm_refine=25)
    want = jsnp_gwas.run_snp_arm(base, str(tmp_path / "jax"), used, y, yt,
                                 names, w, U, **kw)
    got = psnp_gwas.run_snp_arm(base, str(tmp_path / "port"), used, y, yt,
                                names, w, U, device=CPU, **kw)
    assert_same_snp_artifacts(read_tree(tmp_path / "port"),
                              read_tree(tmp_path / "jax"))
    assert sorted(got["thresholds"]) == ["10per", "5per"]
    for key, v in want["thresholds"].items():
        assert math.isclose(got["thresholds"][key], v, rel_tol=1e-9)
    assert list(got["best_pvals"]) == list(want["best_pvals"])
    real = (tmp_path / "port" / "snps" / "output" /
            "phenotype_value.assoc.txt").read_text().splitlines()[1:]
    n_real = len(real)
    best = min(real, key=lambda ln: float(ln.split("\t")[8]))
    assert best.split("\t")[1] == "snp17"
    perm = (tmp_path / "port" / "snps" / "output" / "P3.assoc.txt")
    n_perm = len(perm.read_text().splitlines()) - 1
    assert n_perm == n_real if mode == "one_step" else n_perm <= 20
    assert got["n_tests"] == n_real + sum(
        len((tmp_path / "port" / "snps" / "output" / f"{nm}.assoc.txt")
            .read_text().splitlines()) - 1 for nm in names[1:])
    assert {"snps.planes", "snps.scores", "snps.lmm",
            "snps.artifacts"} == set(got["stage_seconds"])


def test_dose_feed_blocks_equal_one_block(tmp_path, monkeypatch):
    """The LMM's dose blocks, forced to a few SNPs each, give what one
    block gives; the feed's doses equal the JAX package's mean-imputed
    dose matrix."""
    base, used, y, yt, names, w, U = arm_inputs(tmp_path, 13, n_perm=2)
    planes = pbed.load_bed_planes(base, used, device=CPU)
    af, _ = psnp_gwas.allele_freqs(planes)
    jdose, jaf, _ = jsnp_gwas._dose_matrix(jbed.load_bed_planes(base, used),
                                           len(used))
    assert np.array_equal(af, jaf)
    cand = torch.arange(planes.presence.shape[0])[None]
    feed = psnp_gwas.dose_feed(planes, torch.from_numpy(af), cand)
    assert np.array_equal(feed(0, cand.shape[1])[0].numpy(), jdose)
    kw = dict(mode="two_steps", n_snps=30, maf=0.05, mac=3,
              n_permutations=2)
    psnp_gwas.run_snp_arm(base, str(tmp_path / "one"), used, y, yt, names,
                          w, U, device=CPU, **kw)
    monkeypatch.setattr(plmm, "_BLOCK_ELEMS", 7 * len(used))
    psnp_gwas.run_snp_arm(base, str(tmp_path / "many"), used, y, yt, names,
                          w, U, device=CPU, **kw)
    assert_same_snp_artifacts(read_tree(tmp_path / "many"),
                              read_tree(tmp_path / "one"))


def test_run_snp_arm_refuses_a_bad_mode(tmp_path):
    with pytest.raises(ValueError, match="unknown SNP mode"):
        psnp_gwas.run_snp_arm("x", str(tmp_path), [], None, None, [], None,
                              None, mode="three_steps", n_snps=1, maf=0.05,
                              mac=1, n_permutations=0, device=CPU)


def test_snp_entry_points_default_to_the_card(tmp_path, monkeypatch):
    base, names, _ = make_bed(tmp_path, 14, m=10, n=8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: pbed.load_bed_planes(base),
                 lambda: pkinship.emma_kinship_from_bed(base),
                 lambda: port_cli(["kinship-bed", base])):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
