"""Parity of the PyTorch port's ops (kmersgwas_tpu_torch.ops) with the JAX
package, on the CPU.

The same numpy inputs go through the JAX function and its port. Dyadic
phenotypes (multiples of 1/8) make every f32 sum exact in any order, so
scores must agree bit for bit; Gaussian phenotypes at precision "highest"
are held to 1e-5 of the score plus 1e-5 of the column's largest score (the
two matmuls sum in different orders; see RTOL). Where the
JAX side reaches a Pallas kernel it runs in interpret mode, as
tests/test_ops.py runs it.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kmersgwas_tpu.ops import bitplanes as jbits
from kmersgwas_tpu.ops import scanstep as jss
from kmersgwas_tpu.ops import score as jscore
from kmersgwas_tpu_torch.ops import bitplanes, score, topk

# Gaussian phenotypes: f32 sums in different orders. The score's numerator
# N*yigi - n1*ysum cancels, so an ulp of N*yigi moves a score s by about
# 2*sqrt(s/denom) ulps: the bound is relative to the score and to the
# column's largest score, |d| <= RTOL * (|s| + max|s|)
RTOL = 1e-5


def assert_scores_close(got, want):
    fin = np.isfinite(want)
    np.testing.assert_array_equal(np.isfinite(got), fin)
    scale = np.where(fin, np.abs(want), 0).max(axis=-1, keepdims=True)
    d = np.abs(np.where(fin, got, 0) - np.where(fin, want, 0))
    assert (d <= RTOL * (np.where(fin, np.abs(want), 0) + scale)).all(), \
        d.max()


def dyadic(rng, shape):
    return np.round(rng.uniform(-8, 8, size=shape) * 8) / 8


def problem(seed, r=256, n=100, p=3, gaussian=False, pad_rows=0):
    """Packed planes (uint32), popcounts and phenotypes; the last
    `pad_rows` rows are padding (no bits, popcnt 0)."""
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    bits = rng.integers(0, 2, size=(r, n)).astype(np.uint8)
    if pad_rows:
        bits[r - pad_rows:] = 0
    padded = np.zeros((r, n_pad), np.uint8)
    padded[:, :n] = bits
    packed = jbits.pack_bits_np(padded)
    y = (rng.normal(size=(n, p)) if gaussian else dyadic(rng, (n, p)))
    y = y.astype(np.float32)
    yp, ysum = jscore.prepare_phenotypes(y, n_pad)
    return dict(bits=bits, packed=packed, pc=bits.sum(1).astype(np.float32),
                y=y, yp=np.array(yp), ysum=np.array(ysum), n=n)


def torch_args(pb):
    return (bitplanes.as_planes(pb["packed"]), torch.from_numpy(pb["pc"]),
            torch.from_numpy(pb["yp"]), torch.from_numpy(pb["ysum"]))


def jax_args(pb):
    return (jnp.asarray(pb["packed"]), jnp.asarray(pb["pc"]),
            jnp.asarray(pb["yp"]), jnp.asarray(pb["ysum"]))


def jax_scores_t(pb, min_count=2):
    sc = np.asarray(jscore.score_batch(*jax_args(pb), n_used=pb["n"],
                                       min_count=min_count)).T
    return np.where(pb["pc"][None, :] > 0, sc, -np.inf).astype(np.float32)


def test_unpack_and_popcount_match_jax():
    pb = problem(0, r=64, n=100)
    packed = pb["packed"].copy()
    packed[:, 0] |= np.uint32(1 << 31)          # sign bit of the int32 view
    want = np.asarray(jbits.unpack_bits(jnp.asarray(packed)))
    got = bitplanes.unpack_bits(bitplanes.as_planes(packed)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        bitplanes.popcount_rows(bitplanes.as_planes(packed)).numpy(),
        np.asarray(jbits.popcount_rows(jnp.asarray(packed))))
    np.testing.assert_array_equal(bitplanes.pack_bits_np(want.astype(np.uint8)),
                                  packed)


@pytest.mark.parametrize("gaussian,precision", [
    (False, "default"), (False, "highest"), (True, "highest")])
def test_scores_t_plain_matches_score_batch(gaussian, precision):
    pb = problem(2, gaussian=gaussian, pad_rows=7)
    got = score.scores_t_plain(*torch_args(pb), n_used=pb["n"], min_count=2,
                               precision=precision).numpy()
    want = jax_scores_t(pb)
    if gaussian:
        assert_scores_close(got, want)
    else:
        np.testing.assert_array_equal(got, want)


def test_default_precision_rounds_phenotypes_to_bf16():
    """"default" multiplies by bf16-rounded y: on Gaussian phenotypes it
    equals "highest" run on the rounded y, and differs from unrounded y."""
    pb = problem(3, gaussian=True)
    args = torch_args(pb)
    rounded = args[2].to(torch.bfloat16).to(torch.float32)
    kw = dict(n_used=pb["n"], min_count=2)
    d = score.scores_t_plain(*args, precision="default", **kw)
    h = score.scores_t_plain(args[0], args[1], rounded, args[3],
                             precision="highest", **kw)
    torch.testing.assert_close(d, h, rtol=0, atol=0)
    assert not torch.equal(d, score.scores_t_plain(*args, precision="highest",
                                                   **kw))
    with pytest.raises(ValueError):
        score.scores_t_plain(*args, precision="tf32", **kw)


def test_scores_and_bmax_plain_matches_pallas_bmax():
    pb = problem(13, pad_rows=5)
    with pltpu.force_tpu_interpret_mode():
        sc_j, _ = jscore.score_batch_t_pallas_bmax(
            *jax_args(pb), n_used=pb["n"], min_count=2, tile_rows=128,
            block=16)
    sc, bmax = score.scores_and_bmax_plain(*torch_args(pb), n_used=pb["n"],
                                           min_count=2, block=16)
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_j))
    # contiguous 16-lane blocks (the port's layout, ops/topk.top_k_from_bmax)
    np.testing.assert_array_equal(
        bmax.numpy(), np.asarray(sc_j).reshape(3, -1, 16).max(axis=2))


@pytest.mark.parametrize("q", [None, 0.9, 0.999, "inf"])
def test_topw_plain_matches_reference(q):
    """topw_plain against the reference's XLA mirror (_topw_xla) and its
    interpret-mode Pallas kernel, at tests/test_ops.py's shape: equal
    candidate values; the port's guard is implied by the reference's
    (whose extra n2/n3 guards exist only for sum-encoded lanes); where both
    sides say ok the hot (value, lane) pairs agree; and the port's ok
    (with the step's W-th <= thresh check) means every lane scoring
    > thresh is in the list."""
    pb = problem(34)
    sc = jax_scores_t(pb)
    th_val = (-np.inf if q is None else np.inf if q == "inf"
              else np.quantile(sc, q))
    th = np.full(3, th_val, np.float32)
    jargs = jax_args(pb)
    v_x, g_x, ok_x = jss._topw_xla(*jargs, jnp.asarray(th), pb["n"], 2, 64,
                                   128)
    with pltpu.force_tpu_interpret_mode():
        v_p, _, ok_p = jscore.score_batch_t_pallas_topw(
            *jargs, jnp.asarray(th), n_used=pb["n"], min_count=2,
            tile_rows=64, cand_w=128)
    v, g, ok = score.topw_plain(*torch_args(pb), torch.from_numpy(th),
                                n_used=pb["n"], min_count=2, tile_rows=64,
                                cand_w=128)
    v, g, ok = v.numpy(), g.numpy(), ok.numpy()
    np.testing.assert_array_equal(v, np.asarray(v_x))
    np.testing.assert_array_equal(v, -np.sort(-np.asarray(v_p), axis=1))
    assert (np.asarray(ok_x) <= ok).all() and (np.asarray(ok_p) <= ok).all()
    for j in range(3):
        hot = v[j] > th_val
        if ok[j] and ok_x[j] and v[j, -1] <= th_val:
            np.testing.assert_array_equal(g[j][hot], np.asarray(g_x[j])[hot])
        if ok[j] and v[j, -1] <= th_val:
            want = np.nonzero(sc[j] > th_val)[0]
            assert set(want.tolist()) <= set(g[j].tolist())
        # every lane's true score is its value; lanes are distinct
        fin = np.isfinite(v[j])
        np.testing.assert_array_equal(sc[j][g[j][fin]], v[j][fin])
        assert len(set(g[j][fin].tolist())) == fin.sum()


def test_topw_plain_pads_short_lists_like_reference():
    pb = problem(5, r=128)
    th = np.full(3, 1.0, np.float32)
    v_x, g_x, _ = jss._topw_xla(*jax_args(pb), jnp.asarray(th), pb["n"], 2,
                                64, 16)
    v, g, _ = score.topw_plain(*torch_args(pb), torch.from_numpy(th),
                               n_used=pb["n"], min_count=2, tile_rows=64,
                               cand_w=16)
    np.testing.assert_array_equal(v.numpy(), np.asarray(v_x))
    assert (v.numpy()[:, 6:] == -np.inf).all()
    assert (g.numpy()[:, 6:] == 0).all()


@pytest.mark.parametrize("seed", range(4))
def test_blocked_top_k_matches_lax_top_k(seed):
    rng = np.random.default_rng(10 + seed)
    for r in (512, 100):                        # 100 % 16 != 0
        # + 0.0: no -0.0, which scores never hold and lax.top_k orders
        # below +0.0 where torch.sort ties them
        sc = (np.round(rng.normal(size=(3, r)) * 3) / 3 + 0.0).astype(
            np.float32)
        k = int(rng.integers(2, 40))
        v1, i1 = jax.lax.top_k(jnp.asarray(sc), k)
        v2, i2 = topk.blocked_top_k(torch.from_numpy(sc), k, block=16)
        np.testing.assert_array_equal(v2.numpy(), np.asarray(v1))
        np.testing.assert_array_equal(i2.numpy(), np.asarray(i1))


def test_top_k_from_bmax_exact_under_strict_gap():
    rng = np.random.default_rng(12)
    n_exact = 0
    for trial in range(10):
        p, r, k = 3, 512, int(rng.integers(2, 40))
        if trial % 2:    # distinct values: must extract exactly
            sc = rng.permutation(r * p).reshape(p, r).astype(np.float32)
        else:            # heavy ties: the flag must guard correctness
            sc = (np.round(rng.normal(size=(p, r)) * 3) / 3 + 0.0).astype(
                np.float32)
        t = torch.from_numpy(sc)
        v1, i1 = jax.lax.top_k(jnp.asarray(sc), k)
        v2, i2, exact = topk.top_k_from_bmax(t, t.view(p, -1, 16).amax(-1), k)
        assert exact.shape == (p,)
        for c in torch.nonzero(exact).flatten().tolist():
            n_exact += 1
            np.testing.assert_array_equal(v2[c].numpy(), np.asarray(v1[c]))
            np.testing.assert_array_equal(i2[c].numpy(), np.asarray(i1[c]))
        assert bool(exact.all()) or not trial % 2
    assert n_exact >= 15


def test_sort_desc_index_asc_and_row_codec():
    v = torch.tensor([[1.0, 3.0, 3.0, 2.0, 3.0]])
    i = torch.tensor([[9, 7, 2, 4, 5]])
    sv, si = topk.sort_desc_index_asc(v, i)
    assert si.tolist() == [[2, 5, 7, 4, 9]] and sv.tolist() == [[3, 3, 3, 2, 1]]
    rows = np.array([0, 2**31 + 5, 2**33, 123456789012], dtype=np.int64)
    lo, hi = topk.encode_rows(rows)
    np.testing.assert_array_equal(topk.decode_rows(lo, hi), rows)


def test_wrappers_route_by_device():
    """CPU tensors take the plain versions; a tensor on any other non-CUDA
    device is refused (there is no silent plain path off the CPU)."""
    pb = problem(7)
    args = torch_args(pb)
    th = torch.full((3,), 5.0)
    kw = dict(n_used=pb["n"], min_count=2)
    v, g, ok = score.score_batch_t_topw(*args, th, tile_rows=64, cand_w=32,
                                        **kw)
    pv, pg, pok = score.topw_plain(*args, th, tile_rows=64, cand_w=32, **kw)
    assert torch.equal(v, pv) and torch.equal(g, pg) and torch.equal(ok, pok)
    sc, bm = score.score_batch_t_bmax(*args, **kw)
    assert torch.equal(sc, score.scores_and_bmax_plain(*args, **kw)[0])
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        score.score_batch_t_topw(*meta, th.to("meta"), tile_rows=128,
                                 cand_w=32, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        score.score_batch_t_bmax(*meta, **kw)
