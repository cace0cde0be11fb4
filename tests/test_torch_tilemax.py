"""Parity of the port's score_tilemax plain version and of the `cand_c` scan
step (kmersgwas_tpu_torch.ops.score / .scanstep) with the JAX package on
the CPU.

The JAX package sum-encodes a tile's 2nd and 3rd lanes; the port's are
exact. So the nine planes are compared where the reference's are
meaningful: tmax, targ, tmax2, n2 and cnt everywhere; targ2, tmax3 and n3
where n2 == 1; targ3 where n2 == n3 == 1. The step must then make every
decision the reference makes: after every batch the buffer fill and the
threshold are equal, and so are the drained top-k's finite entries.
Phenotypes are dyadic (multiples of 1/8), so scores are exact in any
summation order and the comparisons are bit for bit."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kmersgwas_tpu.ops import bitplanes as jbits
from kmersgwas_tpu.ops import scanstep as jss
from kmersgwas_tpu.ops import score as jscore
from kmersgwas_tpu.ops import topk as jtopk
from kmersgwas_tpu_torch.ops import bitplanes, scanstep, score, topk

N_PAD = 128


def dyadic(rng, shape):
    return (np.round(rng.uniform(-8, 8, size=shape) * 8) / 8).astype(
        np.float32)


def tie_heavy_batch(rng, rows, n, p):
    """Presence bits with duplicated rows inside tiles (runs of 1-4 equal
    rows), a duplicated accession and padding rows; dyadic phenotypes."""
    bits = rng.integers(0, 2, size=(rows, n)).astype(np.uint8)
    bits[:, 1] = bits[:, 0]
    r = 0
    while r < rows:
        run = int(rng.integers(1, 5))
        bits[r:r + run] = bits[r]
        r += run
    bits[rows - rows // 8:] = 0                     # padding rows
    padded = np.zeros((rows, N_PAD), np.uint8)
    padded[:, :n] = bits
    return (jbits.pack_bits_np(padded), bits.sum(1).astype(np.float32),
            dyadic(rng, (n, p)))


def port_planes(packed, pc, y, th, n, tile_rows, min_count=2):
    yp, ysum = score.prepare_phenotypes(y, N_PAD, "cpu")
    return [t.numpy() for t in score.score_batch_t_tilemax(
        bitplanes.as_planes(packed), torch.from_numpy(pc), yp, ysum,
        torch.from_numpy(th), n_used=n, min_count=min_count,
        tile_rows=tile_rows)]


def assert_planes_match(got, want):
    """The masks of the module docstring."""
    tm, ta, tm2, ta2, tm3, ta3, n2, n3, ct = got
    rtm, rta, rtm2, rta2, rtm3, rta3, rn2, rn3, rct = (np.asarray(w)
                                                       for w in want)
    for a, b in ((tm, rtm), (ta, rta), (tm2, rtm2), (n2, rn2), (ct, rct)):
        np.testing.assert_array_equal(a, b)
    one2 = rn2 == 1
    for a, b in ((ta2, rta2), (tm3, rtm3), (n3, rn3)):
        np.testing.assert_array_equal(a[one2], b[one2])
    one3 = one2 & (rn3 == 1)
    np.testing.assert_array_equal(ta3[one3], rta3[one3])
    assert (n2 > 1).any() and (n3 > 1).any() and one3.any()


@pytest.mark.parametrize("th_kind", ["-inf", "quantile", "+inf"])
def test_tilemax_plain_matches_reference(th_kind):
    rng = np.random.default_rng(16)
    n, p, rows, tile = 40, 3, 256, 64
    packed, pc, y = tie_heavy_batch(rng, rows, n, p)
    yp, ysum = jscore.prepare_phenotypes(y, N_PAD)
    jpc = jnp.asarray(pc)
    sc = np.asarray(jss._scores_t_xla(jnp.asarray(packed), jpc, yp, ysum,
                                      n, 2))
    th = np.full(p, {"-inf": -np.inf, "+inf": np.inf,
                     "quantile": np.quantile(sc[np.isfinite(sc)], 0.9)
                     }[th_kind], np.float32)
    got = port_planes(packed, pc, y, th, n, tile)
    assert_planes_match(got, jss._tilemax(jnp.asarray(packed), jpc, yp, ysum,
                                          jnp.asarray(th), n, 2, "xla", tile))
    with pltpu.force_tpu_interpret_mode():
        pallas = jscore.score_batch_t_pallas_tilemax(
            jnp.asarray(packed), jpc, yp, ysum, jnp.asarray(th), n_used=n,
            min_count=2, tile_rows=tile)
    assert_planes_match(got, pallas)


def test_tilemax_plain_matches_chunked_reference():
    """P = 260 > 256: the TPU kernel scores the phenotype axis in chunks
    (kmersgwas_tpu/ops/score.py:437-444); the planes still match."""
    rng = np.random.default_rng(23)
    n, p, rows, tile = 30, 260, 128, 64
    packed, pc, y = tie_heavy_batch(rng, rows, n, p)
    yp, ysum = jscore.prepare_phenotypes(y, N_PAD)
    th = np.full(p, 30.0, np.float32)
    got = port_planes(packed, pc, y, th, n, tile)
    with pltpu.force_tpu_interpret_mode():
        want = jscore.score_batch_t_pallas_tilemax(
            jnp.asarray(packed), jnp.asarray(pc), yp, ysum, jnp.asarray(th),
            n_used=n, min_count=2, tile_rows=tile)
    assert_planes_match(got, want)


def stream(seed, n, p, n_batches, rows=256, tie_column=None):
    rng = np.random.default_rng(seed)
    y = dyadic(rng, (n, p))
    if tie_column is not None:
        y[:, tie_column] = np.sign(y[:, tie_column])   # heavy score ties
    batches = []
    for b in range(n_batches):
        bits = rng.integers(0, 2, size=(rows, n)).astype(np.uint8)
        if tie_column is not None:
            bits[:, 1] = bits[:, 0]                   # duplicated accessions
        padded = np.zeros((rows, N_PAD), np.uint8)
        padded[:, :n] = bits
        lo, hi = jtopk.encode_rows(np.arange(b * rows, (b + 1) * rows))
        batches.append((jbits.pack_bits_np(padded),
                        bits.sum(1).astype(np.float32), lo, hi))
    return y, batches


def finite_top(scores, lo, hi):
    rows = jtopk.decode_rows(np.asarray(lo), np.asarray(hi))
    scores = np.asarray(scores)
    return [(s[np.isfinite(s)], r[np.isfinite(s)])
            for s, r in zip(scores, rows)]


@pytest.mark.parametrize("case", [
    # cand_c2 < cand_c (tests/test_ops.py:555-606): 16 tiles, c=8, c2=2
    dict(seed=17, n=40, p=3, k=16, n_batches=24,
         kw=dict(cand_c=8, cand_c2=2, cand_q=4, tile_rows=16),
         branches=("narrow", "wide", "fallback")),
    # narrow q and column groups (tests/test_ops.py:787-840)
    dict(seed=35, n=40, p=10, k=12, n_batches=24, tie_column=2,
         kw=dict(cand_c=4, cand_q=4, tile_rows=16, col_group=4),
         branches=("narrow", "fallback")),
], ids=["c2", "col_group"])
def test_cand_c_step_matches_jax_after_every_batch(case):
    y, batches = stream(case["seed"], case["n"], case["p"],
                        case["n_batches"], tie_column=case.get("tie_column"))
    k, cap, kw = case["k"], 24, case["kw"]
    yp_j, ysum_j = jscore.prepare_phenotypes(y, N_PAD)
    yp, ysum = score.prepare_phenotypes(y, N_PAD, "cpu")
    common = dict(n_used=case["n"], min_count=2, cand_k=12, **kw)
    ref = jss.init_buffered_state(case["p"], k, buf_cap=cap)
    st = scanstep.init_buffered_state(case["p"], k, cap, "cpu")
    counts = {}
    for packed, pc, lo, hi in batches:
        ref = jss.scan_step_compact(
            ref, jnp.asarray(packed), jnp.asarray(pc), jnp.asarray(lo),
            jnp.asarray(hi), yp_j, ysum_j, kernel="xla", **common)
        scanstep.scan_step_compact(
            st, bitplanes.as_planes(packed), torch.from_numpy(pc),
            torch.from_numpy(lo), torch.from_numpy(hi), yp, ysum,
            counts=counts, **common)
        scanstep.settle(st)         # the step applies its batch one call late
        assert st.buf_n == int(ref.buf_n)
        np.testing.assert_array_equal(st.thresh.numpy(),
                                      np.asarray(ref.thresh))
        got = scanstep.flush_buffered(st)
        want = jss.flush_buffered(ref)
        for (gs, gr), (ws, wr) in zip(
                finite_top(got.scores.numpy(), got.row_lo.numpy(),
                           got.row_hi.numpy()),
                finite_top(want.scores, want.row_lo, want.row_hi)):
            np.testing.assert_array_equal(gs, ws)
            np.testing.assert_array_equal(gr, wr)
    for branch in case["branches"]:
        assert counts.get(branch, 0) >= 1, counts


def test_cand_c_step_equals_cand_w_step():
    """The two candidate modes are exact top-k paths: on the same batches
    they end in the same top-k, scores and rows."""
    y, batches = stream(41, 40, 4, 30)
    yp, ysum = score.prepare_phenotypes(y, N_PAD, "cpu")
    finals = []
    for kw, cap in ((dict(cand_c=8, cand_c2=4), 32),
                    (dict(cand_w=8), 32)):
        st = scanstep.init_buffered_state(4, 16, cap, "cpu")
        for packed, pc, lo, hi in batches:
            scanstep.scan_step_compact(
                st, bitplanes.as_planes(packed), torch.from_numpy(pc),
                torch.from_numpy(lo), torch.from_numpy(hi), yp, ysum,
                n_used=40, min_count=2, cand_k=12, tile_rows=16, cand_q=4,
                **kw)
        finals.append(topk.finalize(scanstep.flush_buffered(st)))
    for (s1, r1), (s2, r2) in zip(*finals):
        np.testing.assert_array_equal(s1, s2)
        np.testing.assert_array_equal(r1, r2)
