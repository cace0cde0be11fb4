"""The rest of the port's EMMA library (kmersgwas_tpu_torch.stats.emma:
ML, the rotated solvers, emma_ML_LRT, emma_REML_t, emma_kinship, mle_noX,
emma_test) and stats.gamma against the JAX package's on the CPU, float64
on both sides (tests/conftest.py turns on x64), inputs made with numpy
from a seed, and against the scipy goldens of tests/goldens.

Tolerances: likelihoods, variance components, p-values and Wald
statistics at rtol 1e-9 (the port takes dLL in closed form where the JAX
package differentiates; the roots agree to the bisection's resolution,
where the likelihood is flat). The LRT statistic 2 (ML1 - ML0) is a
difference of two likelihoods: atol 1e-9 besides. Kinships at atol 1e-12,
gamma at rtol 1e-6 (float32 accumulation, as in the JAX package).
"""
import numpy as np
import pytest
import torch
from scipy import special

from kmersgwas_tpu.stats import emma as jemma
from kmersgwas_tpu.stats.gamma import calc_gamma as jcalc_gamma
from kmersgwas_tpu_torch.stats import emma as pemma
from kmersgwas_tpu_torch.stats.gamma import calc_gamma as pcalc_gamma

from test_goldens import GOLDEN
from test_pipeline import build_population

CPU = "cpu"


def kinship(rng, n):
    G0 = rng.normal(size=(n, 3 * n))
    K = G0 @ G0.T / (3 * n)
    return K / np.diag(K).mean()


def assert_tests_close(got, want):
    """Every field of emma_ML_LRT / emma_REML_t's dicts: the same NaNs,
    rtol 1e-9, and atol 1e-9 on the LRT statistic (module docstring)."""
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        g, w = got[key].numpy(), np.asarray(w, np.float64)
        assert g.shape == w.shape, key
        assert np.array_equal(np.isnan(g), np.isnan(w)), key
        np.testing.assert_allclose(g, w, rtol=1e-9,
                                   atol=1e-9 if key == "stats" else 0,
                                   err_msg=key)


def case(name, seed=21, n=40, m=30, g=2):
    """(ys, xs, K, kwargs) of one configuration."""
    rng = np.random.default_rng(seed)
    K = kinship(rng, n)
    ys = rng.normal(size=(g, n))
    xs = (rng.random((m, n)) < 0.4).astype(float)
    xs[3] = 0.0                                    # monomorphic
    xs[4] = np.where(rng.random(n) < 0.1, 0.5, xs[4])   # hets
    kw = {}
    if name == "nan_X0":
        ys[1, [2, 5]] = np.nan              # a NaN phenotype row
        xs[1, 10] = xs[2, 10] = np.nan      # one mask, two variants
        xs[5, [5, 7]] = np.nan              # other subset sizes
        xs[6, 0] = np.nan
        xs[7, [1, 2, 3]] = np.nan
        kw["X0"] = np.column_stack([np.ones(n), rng.normal(size=n)])
    if name == "Z":
        t = n // 2
        K = kinship(rng, t)
        Z = np.zeros((n, t))
        Z[np.arange(n), np.repeat(np.arange(t), 2)] = 1.0
        kw["Z"] = Z
    return ys, xs, K, kw


@pytest.mark.parametrize("name", ["complete", "nan_X0", "Z"])
@pytest.mark.parametrize("fn", ["emma_ML_LRT", "emma_REML_t"])
def test_emma_tests_match_jax(fn, name):
    ys, xs, K, kw = case(name)
    want = getattr(jemma, fn)(ys, xs, K, n_bisect=50, **kw)
    got = getattr(pemma, fn)(ys, xs, K, n_bisect=50, device=CPU, **kw)
    assert_tests_close(got, want)
    assert got["ps"][3].tolist() == [1.0, 1.0]          # monomorphic


def test_emma_single_phenotype_row_and_emma_test():
    ys, xs, K, _ = case("complete", seed=22, g=1)
    y = ys[0]
    for kw, fn in (({}, jemma.emma_REML_t), ({"use_MLE": True},
                                            jemma.emma_ML_LRT),
                   ({"use_LRT": True}, jemma.emma_ML_LRT)):
        got = pemma.emma_test(y, xs, K, device=CPU, **kw)
        assert_tests_close(got, fn(y, xs, K))


def test_emma_na_tail_by_size(monkeypatch):
    """tests/test_stats.py's 50 distinct NA masks over 5 subset sizes:
    one gathered batch per size and statistic, every value as re-running
    the variant on its own subset (test_emma_tests_match_jax holds the NA
    path to the JAX package)."""
    rng = np.random.default_rng(21)
    n, m = 40, 50
    K = kinship(rng, n)
    y = rng.normal(size=n)
    xs = (rng.random((m, n)) < 0.4).astype(float)
    xs_na = xs.copy()
    for i in range(m):
        xs_na[i, rng.choice(n, size=1 + i % 5, replace=False)] = np.nan
    calls = []
    orig = pemma._gathered

    def spy(core, y_, xs_b, K_, X0, keys, inverse, *a):
        calls.append((core.__name__, xs_b.shape, keys.shape[0]))
        return orig(core, y_, xs_b, K_, X0, keys, inverse, *a)
    monkeypatch.setattr(pemma, "_gathered", spy)
    for fn in ("emma_ML_LRT", "emma_REML_t"):
        got = getattr(pemma, fn)(y, xs_na, K, n_bisect=40, device=CPU)
        for i in (0, 1, 2, 3, 4, 17, 33, 49):
            vv = ~np.isnan(xs_na[i])
            one = getattr(pemma, fn)(y[vv], xs[i:i + 1, vv],
                                     K[np.ix_(vv, vv)], n_bisect=40,
                                     device=CPU)
            np.testing.assert_allclose(got["ps"][i].numpy(),
                                       one["ps"][0].numpy(), rtol=1e-9)
    assert len(calls) == 10
    assert sorted(b for _, (b, _), _ in calls) == [10] * 10
    assert all(u == b for _, (b, _), u in calls)       # 50 distinct masks


def test_gathered_variants_share_one_eigh_per_mask(monkeypatch):
    """Variants with the same NaN mask share their sub-kinship's
    eigendecomposition: 3 masks over 24 variants are 3 matrices."""
    rng = np.random.default_rng(5)
    n, m = 30, 24
    K = kinship(rng, n)
    y = rng.normal(size=n)
    xs = (rng.random((m, n)) < 0.4).astype(float)
    for i in range(m):
        xs[i, [i % 3, 10 + i % 3]] = np.nan
    sizes = []
    orig = torch.linalg.eigh

    def spy(a, *args, **kw):
        sizes.append(tuple(a.shape))
        return orig(a, *args, **kw)
    monkeypatch.setattr(pemma.torch.linalg, "eigh", spy)
    got = pemma.emma_ML_LRT(y, xs, K, n_bisect=40, device=CPU)
    monkeypatch.setattr(pemma.torch.linalg, "eigh", orig)
    assert sizes == [(3, n - 2, n - 2)]
    assert_tests_close(got, jemma.emma_ML_LRT(y, xs, K, n_bisect=40))


def test_emma_ml_lrt_matches_goldens():
    """emma.ML.LRT against the golden direct-ML LRT p-values
    (tests/test_goldens.py's tolerance) and the JAX function."""
    golden = np.load(GOLDEN)
    yc = golden["y"] - golden["y"].mean()
    got = pemma.emma_ML_LRT(yc, golden["variants"], golden["K"], device=CPU)
    np.testing.assert_allclose(got["ps"][:, 0].numpy(), golden["p_lrt"],
                               atol=2e-3)
    assert_tests_close(got, jemma.emma_ML_LRT(yc, golden["variants"],
                                              golden["K"]))


def test_emma_reml_t_formula_transcription():
    """emma.REML.t's Wald t and p (emma.R:1080-1110, 1263) against a
    numpy/scipy transcription at the port's own REML delta
    (tests/test_goldens.py's check)."""
    from scipy import stats as sps
    golden = np.load(GOLDEN)
    yc = golden["y"] - golden["y"].mean()
    K, variants = golden["K"], golden["variants"][:6]
    out = pemma.emma_REML_t(yc, variants, K, device=CPU)
    n = len(yc)
    xi, Q = np.linalg.eigh(K)
    for i, x in enumerate(variants):
        X = np.column_stack([np.ones(n), x])
        res = pemma.remle(yc, K, X=X, device=CPU)
        U = Q * np.sqrt(1.0 / (xi + float(res.delta)))[None, :]
        yt, Xt = U.T @ yc, U.T @ X
        iXX = np.linalg.inv(Xt.T @ Xt)
        beta = iXX @ (Xt.T @ yt)
        stat = beta[1] / np.sqrt(iXX[1, 1] * float(res.vg))
        p = 2 * sps.t.sf(abs(stat), df=n - 2)
        assert np.isclose(float(out["stats"][i, 0]), stat, rtol=1e-4)
        assert np.isclose(float(out["ps"][i, 0]), p, rtol=1e-3, atol=1e-6)


@pytest.mark.parametrize("fn", ["mle", "mle_noX"])
@pytest.mark.parametrize("with_z", [False, True])
def test_mle_matches_jax(fn, with_z):
    rng = np.random.default_rng(8)
    n = 50
    K = kinship(rng, n // 2 if with_z else n)
    y = rng.normal(size=n)
    kw = {}
    if with_z:
        Z = np.zeros((n, n // 2))
        Z[np.arange(n), np.repeat(np.arange(n // 2), 2)] = 1.0
        kw["Z"] = Z
    got = getattr(pemma, fn)(y - y.mean(), K, device=CPU, **kw)
    want = getattr(jemma, fn)(y - y.mean(), K, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-9)


def test_mle_from_eigen_and_rot_solvers_match_jax():
    """mle_from_eigen on the eigen_R system, and the rotated REML / ML
    solvers on the K-eigenbasis, against the JAX functions."""
    import jax.numpy as jnp
    rng = np.random.default_rng(9)
    n = 36
    K = kinship(rng, n)
    y = rng.normal(size=n)
    X = np.column_stack([np.ones(n), rng.random(n) < 0.5])
    lam, vec = jemma.eigen_R(jnp.asarray(K), jnp.asarray(X))
    xi_s = jnp.linalg.eigvalsh(jnp.asarray(K))[::-1]
    etas = vec.T @ jnp.asarray(y)
    want = jemma.mle_from_eigen(etas, lam, xi_s)
    got = pemma.mle_from_eigen(torch.from_numpy(np.array(etas)),
                               torch.from_numpy(np.array(lam)),
                               torch.from_numpy(np.array(xi_s)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=1e-9)
    xi, U = np.linalg.eigh(K)
    Xt, yt = U.T @ X, U.T @ y
    for jf, pf in ((jemma._remle_rot, pemma._remle_rot),
                   (jemma._mle_rot, pemma._mle_rot)):
        want = jf(jnp.asarray(xi), jnp.asarray(Xt), jnp.asarray(yt), -10.0,
                  10.0, 1e-10, 100, 60)
        got = pf(*(torch.from_numpy(a) for a in (xi, Xt, yt)), -10.0, 10.0,
                 1e-10, 100, 60)
        for a, b in zip(got, want):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-9)


@pytest.mark.parametrize("method", ["additive", "dominant", "recessive"])
@pytest.mark.parametrize("use", ["all", "complete.obs"])
def test_emma_kinship_matches_jax(method, use):
    rng = np.random.default_rng(3)
    S = rng.choice([0.0, 0.5, 1.0], size=(60, 14), p=[0.45, 0.1, 0.45])
    S[rng.random(S.shape) < 0.03] = np.nan
    got = pemma.emma_kinship(S, method, use, device=CPU).numpy()
    np.testing.assert_allclose(got, np.asarray(jemma.emma_kinship(
        S, method, use)), rtol=0, atol=1e-12)
    assert np.array_equal(np.diag(got), np.ones(14))


def test_emma_kinship_refuses_unknown_options():
    S = np.zeros((3, 4))
    with pytest.raises(ValueError, match="unknown method"):
        pemma.emma_kinship(S, "codominant", device=CPU)
    with pytest.raises(ValueError, match="unknown use"):
        pemma.emma_kinship(S, use="pairwise", device=CPU)


def test_betainc_and_t_sf_match_scipy():
    """The continued-fraction incomplete beta on both sides of its switch,
    at the Student-t's arguments (a = df/2 up to 5e4, b = 1/2)."""
    rng = np.random.default_rng(4)
    a = np.concatenate([rng.uniform(0.1, 20, 200), rng.uniform(20, 5e4, 200)])
    b = np.concatenate([rng.uniform(0.1, 20, 200), np.full(200, 0.5)])
    x = rng.uniform(0, 1, 400)
    x[:4] = [0.0, 1.0, 1e-12, 1 - 1e-12]
    got = pemma.betainc(*(torch.from_numpy(v) for v in (a, b, x))).numpy()
    np.testing.assert_allclose(got, special.betainc(a, b, x), rtol=1e-9,
                               atol=1e-300)
    df = np.array([3.0, 38.0, 1006.0, 1006.0, 1006.0])
    t = np.array([0.0, 2.5, 1.0, 6.0, 40.0])
    got = pemma._t_sf(torch.from_numpy(t), torch.from_numpy(df)).numpy()
    np.testing.assert_allclose(got, special.stdtr(df, -t), rtol=1e-9)


def test_gamma_factor_matches_jax_and_the_reference(tmp_path):
    """calc_gamma on tests/test_pipeline.py:202's fixture: the JAX
    package's value and the reference's literal loop
    (kmers_multiple_databases.cpp:390-416)."""
    from kmersgwas_tpu_torch.core import formats
    pop = build_population(tmp_path, n_samples=14, n_kmers=150)
    hdr, kmers, pa = formats.read_table(pop["base"])
    n = hdr.n_accessions
    shifts = np.arange(64, dtype=np.uint64)
    bits = ((pa[:, :, None] >> shifts) & np.uint64(1)).reshape(
        len(kmers), -1)[:, :n]
    n1 = bits.sum(axis=1).astype(np.float64)
    keep = (n1 >= 2) & (n1 <= n - 2)
    rng = np.random.default_rng(0)
    A = rng.normal(size=(n, n))
    Vinv = A @ A.T / n
    got = pcalc_gamma(pop["base"], Vinv, min_count=2, device=CPU)
    assert np.isclose(got, jcalc_gamma(pop["base"], Vinv, min_count=2),
                      rtol=1e-6)
    R = np.zeros((n, n))
    for row in np.nonzero(keep)[0]:
        egm = n1[row] / n
        g = (bits[row].astype(np.float64) - egm) \
            * np.sqrt(1.0 / (n * (egm - egm * egm)))
        R += np.outer(g, g)
    assert np.isclose(got, float(np.sum(Vinv * (R / keep.sum()))),
                      rtol=1e-4)
    # max_variants stops after the batch that reaches it
    few = pcalc_gamma(pop["base"], Vinv, min_count=2, max_variants=10,
                      batch_size=7, device=CPU)
    assert np.isclose(few, jcalc_gamma(pop["base"], Vinv, min_count=2,
                                       max_variants=10, batch_size=7),
                      rtol=1e-6)
    with pytest.raises(ValueError, match="shape mismatch"):
        pcalc_gamma(pop["base"], Vinv[1:, 1:], min_count=2, device=CPU)


def test_emma_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(1)
    K = kinship(rng, 6)
    y = rng.normal(size=6)
    for call in (lambda: pemma.mle(y, K), lambda: pemma.mle_noX(y, K),
                 lambda: pemma.emma_ML_LRT(y, y[None], K),
                 lambda: pemma.emma_REML_t(y, y[None], K),
                 lambda: pemma.emma_kinship(K)):
        with pytest.raises(RuntimeError, match="is_available"):
            call()
