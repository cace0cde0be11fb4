"""The port's statistics (kmersgwas_tpu_torch.stats) against the JAX
package's (kmersgwas_tpu.stats) on the CPU, float64 on both sides (the JAX
side under jax.enable_x64), inputs made with numpy from a seed.

Tolerances: REML and the permutations are held at rtol 1e-9 / 1e-10. The
LMM's maximized log-likelihoods and p-values at rtol 1e-9 and 1e-6. Its
log10 lambda and beta are the argmax of a profile likelihood that is flat
to its float64 rounding near the optimum, where the golden-section
search's last steps follow rounding noise in either package; the flatter
the profile, the wider they wander (2.7e-5 in log10 lambda on the JAX
packed test's data, which has no genetic signal): held at atol 1e-4 and
at rtol 1e-5 plus 1e-5 of the column's largest |beta|.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special, stats

from kmersgwas_tpu.pipeline import align as jalign
from kmersgwas_tpu.stats import emma as jemma
from kmersgwas_tpu.stats import lmm as jlmm
from kmersgwas_tpu.stats import transform as jtransform
from kmersgwas_tpu.stats.mvnpermute import mvnpermute as jmvnpermute
from kmersgwas_tpu_torch.ops.bitplanes import pack_bits_np
from kmersgwas_tpu_torch.pipeline import align as palign
from kmersgwas_tpu_torch.stats import emma as pemma
from kmersgwas_tpu_torch.stats import lmm as plmm
from kmersgwas_tpu_torch.stats import mvnpermute as pmvn
from kmersgwas_tpu_torch.stats import transform as ptransform

from test_goldens import GOLDEN
from test_stats import make_kinship, reference_remle, simulate_phenotype

CPU = "cpu"


def jax_draws(seed, nr, n):
    """The indices jax.random.permutation draws for mvnpermute's key:
    jax.random.permutation(k, z) == z[jax.random.permutation(k, n)]."""
    keys = jax.random.split(jax.random.PRNGKey(seed), nr)
    return np.asarray(jax.vmap(lambda k: jax.random.permutation(k, n))(keys),
                      np.int64)


def lmm_inputs(seed, n=80, m=50, p=3, effect=0.8):
    rng = np.random.default_rng(seed)
    G0 = rng.normal(size=(n, 2 * n))
    K = G0 @ G0.T / (2 * n)
    K = K / np.diag(K).mean()
    w, U = np.linalg.eigh(K)
    genos = (rng.random((p, m, n)) < 0.4).astype(np.float64)
    ys = (np.linalg.cholesky(K + np.eye(n)) @ rng.normal(size=(n, p))).T \
        + effect * genos[:, 0, :]
    return rng, K, w, U, genos, ys


def assert_lmm_close(got, want):
    """p_lrt at rtol 1e-6, logl_alt at rtol 1e-9, log10 lambda at atol
    1e-4, beta at rtol 1e-5 plus 1e-5 of the largest |beta| (module
    docstring)."""
    g = {f: getattr(got, f).numpy() for f in got._fields}
    w = {f: np.asarray(getattr(want, f), np.float64) for f in want._fields}
    np.testing.assert_allclose(g["p_lrt"], w["p_lrt"], rtol=1e-6)
    np.testing.assert_allclose(g["logl_alt"], w["logl_alt"], rtol=1e-9)
    np.testing.assert_allclose(g["log10_lambda"], w["log10_lambda"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(g["beta"], w["beta"], rtol=1e-5,
                               atol=1e-5 * np.abs(w["beta"]).max())


@pytest.mark.parametrize("vg,ve", [(1.0, 1.0), (2.0, 0.3), (0.1, 2.0)])
def test_remle_matches_jax_and_the_transcription(vg, ve):
    rng = np.random.default_rng(42)
    K = make_kinship(rng, 60)
    y = simulate_phenotype(rng, K, vg, ve)
    y = y - y.mean()
    with jax.enable_x64(True):
        want = jemma.remle(y, K)
    got = pemma.remle(y, K, device=CPU)
    assert got.vg.dtype == torch.float64
    for f in ("vg", "ve", "delta", "reml_ll"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-9)
    np.testing.assert_allclose(float(pemma.heritability(got)),
                               float(jemma.heritability(want)), rtol=1e-9)
    ref = reference_remle(y, K)       # scipy transcription of emma.REMLE
    assert np.isclose(float(got.delta), ref["delta"], rtol=1e-3)
    assert np.isclose(float(got.reml_ll), ref["ll"], rtol=1e-5)


def test_remle_matches_goldens():
    """tests/goldens/stats_goldens.npz at test_goldens.py's tolerances."""
    golden = np.load(GOLDEN)
    y = golden["y"] - golden["y"].mean()
    res = pemma.remle(y, golden["K"], device=CPU)
    assert np.isclose(float(res.vg), float(golden["vg"]), rtol=2e-2)
    assert np.isclose(float(res.ve), float(golden["ve"]), rtol=2e-2)
    assert np.isclose(float(pemma.heritability(res)),
                      float(golden["heritability"]), atol=2e-3)


def test_remle_with_Z_and_X_matches_jax():
    """The Z incidence matrix (K_eff = Z K Z') and explicit covariates."""
    rng = np.random.default_rng(19)
    t, reps = 15, 2
    Kt = make_kinship(rng, t)
    Z = np.zeros((t * reps, t))
    Z[np.arange(t * reps), np.repeat(np.arange(t), reps)] = 1.0
    y = rng.normal(size=t * reps)
    X = np.stack([np.ones(t * reps), rng.normal(size=t * reps)], 1)
    with jax.enable_x64(True):
        want = jemma.remle(y, Kt, X=X, Z=Z)
    got = pemma.remle(y, Kt, X=X, Z=Z, device=CPU)
    for f in ("vg", "ve", "delta", "reml_ll"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-9)


@pytest.mark.parametrize("vg,ve", [(0.0, 1.0), (1.0, 0.0)])
def test_remle_at_the_grid_boundaries_matches_jax(vg, ve):
    """A phenotype with no genetic part (a large delta) and one with no
    noise, where the lower end of the grid wins the masked argmax: both
    packages pick the same candidate."""
    rng = np.random.default_rng(3)
    n = 40
    K = make_kinship(rng, n)
    y = simulate_phenotype(rng, K, vg, ve)
    y -= y.mean()
    with jax.enable_x64(True):
        want = jemma.remle(y, K)
    got = pemma.remle(y, K, device=CPU)
    for f in ("vg", "ve", "delta", "reml_ll"):
        np.testing.assert_allclose(float(getattr(got, f)),
                                   float(getattr(want, f)), rtol=1e-9)


def test_is_positive_semi_definite():
    rng = np.random.default_rng(1)
    K = make_kinship(rng, 30)
    bad = K.copy()
    bad[0, 1] = bad[1, 0] = 5.0
    for M, expect in ((K, True), (bad, False)):
        assert pemma.is_positive_semi_definite(M, device=CPU) is expect
        with jax.enable_x64(True):
            assert jemma.is_positive_semi_definite(M) is expect


def test_mvnpermute_with_jax_draws_matches_jax(monkeypatch):
    rng = np.random.default_rng(2)
    n, nr, seed = 40, 25, 7
    K = make_kinship(rng, n)
    V = 1.5 * K + 0.5 * np.eye(n)
    y = simulate_phenotype(rng, K, 1.5, 0.5)
    X = np.stack([np.ones(n), rng.normal(size=n)], 1)
    monkeypatch.setattr(pmvn, "draw_permutations",
                        lambda s, r, m: jax_draws(s, r, m))
    with jax.enable_x64(True):
        want = np.asarray(jmvnpermute(jax.random.PRNGKey(seed),
                                      jnp.asarray(y), jnp.asarray(X),
                                      jnp.asarray(V), nr))
    got = pmvn.mvnpermute(seed, y, X, V, nr, device=CPU)
    assert got.shape == (n, nr) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-10, atol=1e-12)


def test_mvnpermute_preserves_moments():
    """The port's own draws: every replicate's whitened residuals are a
    permutation of the original's (test_stats.py's invariant), and the
    draws are permutations from numpy.random.Generator(seed)."""
    rng = np.random.default_rng(2)
    n = 40
    K = make_kinship(rng, n)
    V = 1.5 * K + 0.5 * np.eye(n)
    y = simulate_phenotype(rng, K, 1.5, 0.5)
    perms = pmvn.mvnpermute(0, y, np.ones((n, 1)), V, 50,
                            device=CPU).numpy()
    assert perms.shape == (n, 50)
    Vinv = np.linalg.inv(V)
    b = (np.ones(n) @ Vinv @ y) / (np.ones(n) @ Vinv @ np.ones(n))
    L = np.linalg.cholesky(V)
    z = np.sort(np.linalg.solve(L, y - b))
    for r in range(perms.shape[1]):
        zr = np.sort(np.linalg.solve(L, perms[:, r] - b))
        np.testing.assert_allclose(zr, z, rtol=1e-6, atol=1e-8)
    assert np.std(perms, axis=1).max() > 0.1
    d = pmvn.draw_permutations(0, 50, n)
    assert d.shape == (50, n) and d.dtype == np.int64
    assert (np.sort(d, axis=1) == np.arange(n)).all()
    np.testing.assert_array_equal(d, pmvn.draw_permutations(0, 50, n))
    assert not np.array_equal(d, pmvn.draw_permutations(1, 50, n))


def test_transform_and_permute_matches_jax(monkeypatch):
    rng = np.random.default_rng(5)
    n, n_perm = 50, 20
    K = make_kinship(rng, n)
    y = simulate_phenotype(rng, K, 1.0, 0.7) + 3.0
    monkeypatch.setattr(pmvn, "draw_permutations",
                        lambda s, r, m: jax_draws(s, r, m))
    with jax.enable_x64(True):
        want = jtransform.transform_and_permute(y, K, n_perm, seed=4)
    got = ptransform.transform_and_permute(y, K, n_perm, seed=4)
    assert got.names == want.names
    for f in ("vg", "ve", "heritability"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-9)
    for f in ("phenotypes", "transformed"):
        np.testing.assert_allclose(getattr(got, f), getattr(want, f),
                                   rtol=1e-9, atol=1e-12)
    bad = K.copy()
    bad[0, 1] = bad[1, 0] = 5.0
    with pytest.raises(ValueError, match="positive semi-definite"):
        ptransform.transform_and_permute(y, bad, 2)


def test_permutation_threshold_order_statistic():
    rng = np.random.default_rng(6)
    best = {f"P{i}": float(v) for i, v in
            enumerate(rng.exponential(size=100), 1)}
    best["phenotype_value"] = 99.0
    for p in (0.05, 0.10):
        assert ptransform.permutation_threshold(best, 100, p) == \
            jtransform.permutation_threshold(best, 100, p)
    assert ptransform.permutation_threshold(best, 100, 0.05) == sorted(
        (best[f"P{i}"] for i in range(1, 101)), reverse=True)[4]


@pytest.mark.parametrize("covariates", [False, True])
def test_lmm_scan_matches_jax(covariates):
    rng, K, w, U, genos, ys = lmm_inputs(0)
    cov = np.stack([np.ones(80), rng.normal(size=80)], 1) \
        if covariates else None
    with jax.enable_x64(True):
        want = jlmm.lmm_scan(genos[0], ys[0], w, U, covariates=cov)
    got = plmm.lmm_scan(genos[0], ys[0], w, U, covariates=cov, device=CPU)
    assert got.p_lrt.shape == (50,)
    assert_lmm_close(got, want)


@pytest.mark.parametrize("seed,n", [(1, 40), (2, 96)])
def test_lmm_scan_columns_matches_jax(seed, n):
    _, _, w, U, genos, ys = lmm_inputs(seed, n=n, m=40)
    with jax.enable_x64(True):
        want = jlmm.lmm_scan_columns(genos, ys, w, U, n_grid=48, n_refine=30)
    got = plmm.lmm_scan_columns(genos, ys, w, U, n_grid=48, n_refine=30,
                                device=CPU)
    assert got.p_lrt.shape == (3, 40)
    assert_lmm_close(got, want)


def test_lmm_scan_columns_in_blocks_equals_one_block(monkeypatch):
    """The candidate blocks that bound the stack's memory change nothing:
    each candidate's arithmetic is its own."""
    _, _, w, U, genos, ys = lmm_inputs(3, m=37)
    whole = plmm.lmm_scan_columns(genos, ys, w, U, device=CPU)
    monkeypatch.setattr(plmm, "_BLOCK_ELEMS", 3 * 80 * 5)   # 5 a block
    blocks = plmm.lmm_scan_columns(genos, ys, w, U, device=CPU)
    for f in whole._fields:
        np.testing.assert_allclose(getattr(blocks, f).numpy(),
                                   getattr(whole, f).numpy(), rtol=1e-12,
                                   atol=1e-12)


def test_lmm_goldens():
    """tests/goldens/stats_goldens.npz's direct ML-LRT p-values at
    test_goldens.py's tolerances."""
    golden = np.load(GOLDEN)
    y = golden["y"] - golden["y"].mean()
    w, U = np.linalg.eigh(golden["K"])
    res = plmm.lmm_scan(golden["variants"], y, w, U, n_grid=128,
                        n_refine=60, device=CPU)
    p, ref = res.p_lrt.numpy(), golden["p_lrt"]
    np.testing.assert_allclose(p, ref, atol=2e-3)
    small = ref < 0.05
    if small.any():
        np.testing.assert_allclose(np.log10(p[small]), np.log10(ref[small]),
                                   atol=2e-2)


def jax_test_packed_inputs():
    """tests/test_stats.py:343-369's data: n=96, 40 candidates, 3
    columns, packed LSB-first into uint32 words."""
    rng = np.random.default_rng(17)
    n, m, p = 96, 40, 3
    G0 = rng.normal(size=(n, 2 * n))
    K = G0 @ G0.T / (2 * n)
    K = K / np.diag(K).mean()
    w, U = np.linalg.eigh(K)
    genos = (rng.random((p, m, n)) < 0.4).astype(np.float64)
    ys = rng.normal(size=(p, n))
    n64 = (n + 63) // 64
    bits = np.zeros((p, m, n64 * 64), np.uint8)
    bits[:, :, :n] = genos
    packed = np.packbits(bits, axis=2, bitorder="little").view("<u4")
    return n, w, U, genos, ys, packed


def assert_float32_close(p32, p64, lrt_tol):
    """float32 (device32) p-values against float64 ones: log10 p within
    5e-2 where p < 0.05, and p within 2e-3 (the JAX package's tolerances,
    tests/test_stats.py:343-369) or else the LRT within lrt_tol. Near p = 1
    the LRT is ~0 and p = erfc(sqrt(LRT / 2)) turns a float32 LRT error e
    into a p error ~sqrt(e): at n=96 one p near 1 is off by more than
    2e-3."""
    p32 = np.asarray(p32, np.float64)
    small = p64 < 0.05
    if small.any():
        np.testing.assert_allclose(np.log10(p32[small]),
                                   np.log10(p64[small]), atol=5e-2)
    dlrt = np.abs(stats.chi2.isf(p32, 1) - stats.chi2.isf(p64, 1))
    bad = (np.abs(p32 - p64) > 2e-3) & (dlrt > lrt_tol)
    assert not bad.any(), (p32[bad], p64[bad], dlrt[bad])


def test_lmm_packed_matches_host64():
    """float32 (device32) against the float64 route on the JAX package's
    test data; the LRT held at 2e-4 where p is off by more than 2e-3."""
    n, w, U, genos, ys, packed = jax_test_packed_inputs()
    ref = plmm.lmm_scan_columns(genos, ys, w, U, device=CPU)
    got = plmm.lmm_scan_columns_packed(packed, ys, w, U, n=n, device=CPU)
    assert got.p_lrt.dtype == torch.float32
    assert_float32_close(got.p_lrt.numpy(), ref.p_lrt.numpy(), 2e-4)


def test_lmm_packed_matches_jax_packed():
    """Against the JAX packed route. Under the tests' x64 the JAX route
    runs its lambda grid, and so most of its arithmetic, in float64, so
    the port's float32 is held to it as to float64 (the test above); the
    port's packed route in float64 (host64's arithmetic on the unpacked
    bits) at the float64 tolerances, against both JAX routes."""
    n, w, U, genos, ys, packed = jax_test_packed_inputs()
    with jax.enable_x64(True):
        want = jlmm.lmm_scan_columns_packed(packed, ys, w, U, n=n)
    p_want = np.asarray(want.p_lrt, np.float64)
    got32 = plmm.lmm_scan_columns_packed(packed, ys, w, U, n=n, device=CPU)
    assert_float32_close(got32.p_lrt.numpy(), p_want, 2e-4)
    got64 = plmm.lmm_scan_columns_packed(packed, ys, w, U, n=n, device=CPU,
                                         dtype=torch.float64)
    np.testing.assert_allclose(got64.p_lrt.numpy(), p_want, rtol=0,
                               atol=1e-5)
    with jax.enable_x64(True):
        host = jlmm.lmm_scan_columns(genos, ys, w, U)
    assert_lmm_close(got64, host)


def test_lmm_packed_takes_int32_planes_and_empty_stacks():
    n, w, U, genos, ys, packed = jax_test_packed_inputs()
    a = plmm.lmm_scan_columns_packed(packed, ys, w, U, n=n, device=CPU)
    planes = torch.from_numpy(pack_bits_np(
        np.pad(genos, ((0, 0), (0, 0), (0, 32))).astype(np.uint8)
    ).view(np.int32))
    b = plmm.lmm_scan_columns_packed(planes, ys, w, U, n=n, device=CPU)
    for f in a._fields:
        np.testing.assert_array_equal(getattr(a, f).numpy(),
                                      getattr(b, f).numpy())
    e = plmm.lmm_scan_columns_packed(packed[:, :0], ys, w, U, n=n,
                                     device=CPU)
    assert all(getattr(e, f).shape == (3, 0) for f in e._fields)


def test_chi2_sf_df1_matches_scipy():
    x = np.array([0.0, 1e-8, 0.5, 1.0, 3.84, 10.0, 50.0, 200.0, -1.0])
    got = plmm.chi2_sf_df1(torch.from_numpy(x)).numpy()
    want = stats.chi2.sf(np.maximum(x, 0.0), 1)
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    np.testing.assert_allclose(got, special.erfc(np.sqrt(np.maximum(
        x, 0) / 2)), rtol=1e-14)
    with jax.enable_x64(True):
        np.testing.assert_allclose(got, np.asarray(jlmm.chi2_sf_df1(x)),
                                   rtol=1e-13)


def test_grammar_gamma_score_matches_jax():
    rng = np.random.default_rng(8)
    n = 50
    genos = (rng.random((200, n)) < rng.uniform(0.01, 0.99, (200, 1))
             ).astype(np.float32)
    y = rng.normal(size=n).astype(np.float32)
    want = np.asarray(jlmm.grammar_gamma_score(genos, y, n, 3))
    got = plmm.grammar_gamma_score(genos, y, n, 3, device=CPU).numpy()
    assert (got == 0).sum() == (want == 0).sum() > 0
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_align_helpers_match_jax():
    accs = ["a", "b", "a", "c", "d", "b"]
    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 0.5]
    assert palign.average_phenotypes(accs, vals)[0] == \
        jalign.average_phenotypes(accs, vals)[0] == ["a", "b", "c", "d"]
    np.testing.assert_array_equal(palign.average_phenotypes(accs, vals)[1],
                                  jalign.average_phenotypes(accs, vals)[1])
    u_accs, u_vals = palign.average_phenotypes(accs, vals)
    kin_names = ["c", "a", "x", "b", "d"]
    Kf = np.arange(25, dtype=np.float64).reshape(5, 5)
    args = (u_accs, u_vals, kin_names, Kf, ["a", "b", "c", "zzz"])
    got, want = palign.intersect_accessions(*args), \
        jalign.intersect_accessions(*args)
    assert got[0] == want[0] == ["a", "b", "c"]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


def test_stats_refuse_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    K = np.eye(4)
    with pytest.raises(RuntimeError, match="is_available"):
        pemma.remle(np.arange(4.0), K)
    with pytest.raises(RuntimeError, match="is_available"):
        plmm.lmm_scan_columns(np.zeros((1, 2, 4)), np.zeros((1, 4)),
                              np.ones(4), K)
