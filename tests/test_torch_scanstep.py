"""Parity of the port's scan step (kmersgwas_tpu_torch.ops.scanstep) with
the JAX package on the CPU: tie-heavy streams (the streams of
tests/test_ops.py's cand_w and col_group tests, with dyadic phenotypes so
both sides' scores are bit-equal) must end in the same top-k — scores AND
rows — as the JAX package's plain `scan_step`, with the narrow, wide and
fallback branches all engaged; and a JAX mid-stream state handed to the
port (kmersgwas_tpu_torch.convert) must end where JAX ends."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmersgwas_tpu.ops import bitplanes as jbits
from kmersgwas_tpu.ops import scanstep as jss
from kmersgwas_tpu.ops import score as jscore
from kmersgwas_tpu.ops import topk as jtopk
from kmersgwas_tpu_torch import convert
from kmersgwas_tpu_torch.ops import bitplanes, scanstep, topk

N, N_PAD, ROWS, MIN_COUNT = 40, 128, 256, 2


def stream(seed, p, n_batches, tie_column=None):
    """Batches of random presence bits (numpy) + dyadic phenotypes."""
    rng = np.random.default_rng(seed)
    y = np.round(rng.uniform(-8, 8, size=(N, p)) * 8) / 8
    if tie_column is not None:
        y[:, tie_column] = np.sign(y[:, tie_column])   # heavy score ties
    batches = []
    for b in range(n_batches):
        bits = rng.integers(0, 2, size=(ROWS, N)).astype(np.uint8)
        if tie_column is not None:
            bits[:, 1] = bits[:, 0]                   # duplicated accessions
        padded = np.zeros((ROWS, N_PAD), np.uint8)
        padded[:, :N] = bits
        lo, hi = jtopk.encode_rows(np.arange(b * ROWS, (b + 1) * ROWS))
        batches.append((jbits.pack_bits_np(padded),
                        bits.sum(1).astype(np.float32), lo, hi))
    return y.astype(np.float32), batches


def jax_plain_final(y, batches, k):
    yp, ysum = jscore.prepare_phenotypes(y, N_PAD)
    st = jtopk.init_state(y.shape[1], k)
    for packed, pc, lo, hi in batches:
        st = jss.scan_step(st, jnp.asarray(packed), jnp.asarray(pc),
                           jnp.asarray(lo), jnp.asarray(hi), yp, ysum,
                           n_used=N, min_count=MIN_COUNT, kernel="xla",
                           cand_k=8)
    return np.asarray(st.scores), jtopk.decode_rows(np.asarray(st.row_lo),
                                                    np.asarray(st.row_hi))


def port_batch(b):
    packed, pc, lo, hi = b
    return (bitplanes.as_planes(packed), torch.from_numpy(pc),
            torch.from_numpy(lo), torch.from_numpy(hi))


def port_run(state, y, batches, counts, **kw):
    yp, ysum = (torch.from_numpy(a) for a in _prep(y))
    for b in batches:
        scanstep.scan_step_compact(state, *port_batch(b), yp, ysum,
                                   n_used=N, min_count=MIN_COUNT, cand_k=12,
                                   counts=counts, **kw)
    final = scanstep.flush_buffered(state)
    return final.scores.numpy(), topk.decode_rows(final.row_lo.numpy(),
                                                  final.row_hi.numpy())


def _prep(y):
    yp = np.zeros((N_PAD, y.shape[1]), np.float32)
    yp[:N] = y
    return yp, y.astype(np.float64).sum(0).astype(np.float32)


@pytest.mark.parametrize("tile_rows", [64, 16])
def test_step_stream_matches_jax(tile_rows):
    y, batches = stream(33, p=3, n_batches=30)
    want_s, want_r = jax_plain_final(y, batches, k=16)
    counts = {}
    st = scanstep.init_buffered_state(3, 16, buf_cap=24, device="cpu")
    got_s, got_r = port_run(st, y, batches, counts, tile_rows=tile_rows,
                            cand_w=8, cand_q=4)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_r, want_r)
    assert counts.get("narrow", 0) >= 3, counts
    assert counts.get("fallback", 0) >= 1, counts
    assert counts.get("wide", 0) >= 1, counts


def test_col_group_stream_matches_jax():
    """col_group=4 over P=10: groups [0:4) [4:8) [8:10) decide apart; the
    quantized column 2 keeps its group falling back while others append."""
    y, batches = stream(35, p=10, n_batches=24, tie_column=2)
    want_s, want_r = jax_plain_final(y, batches, k=12)
    counts = {}
    st = scanstep.init_buffered_state(10, 12, buf_cap=24, device="cpu")
    got_s, got_r = port_run(st, y, batches, counts, tile_rows=16, cand_w=8,
                            cand_q=4, col_group=4)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_r, want_r)
    assert counts.get("fallback", 0) >= 1, counts
    assert counts.get("narrow", 0) + counts.get("wide", 0) >= 5, counts


def test_flush_merge_picks_a_tier_per_column(monkeypatch):
    """The exact wide merge equals a stable sort of (state, buffer, whole
    batch) when column 0 is exact at the cand_k tier, column 1 only at the
    8192 tier and column 2 (empty state, tied scores) at neither, so only
    column 2 takes the full top-k."""
    rng = np.random.default_rng(5)
    k, cap, r, cand_k = 9000, 256, 32768, 1000
    perm = lambda n: rng.permutation(n).astype(np.float32)   # noqa: E731
    state_v = np.stack([100 + perm(k) / k * 100, perm(k) / k * 1000,
                        np.full(k, -np.inf, np.float32)])
    sc = np.stack([perm(r) / r * 100, perm(r) / r * 1000,
                   np.round(rng.normal(size=r) * 4).astype(np.float32)])
    buf_v = np.round(rng.normal(size=(3, cap)) * 4).astype(np.float32) + 50
    state_v = -np.sort(-state_v, axis=1)
    ids = lambda n, base: np.tile(np.arange(base, base + n, dtype=np.int32),
                                  (3, 1))                     # noqa: E731
    s_lo, b_lo, row_lo = ids(k, 0), ids(cap, k), ids(r, k + cap)[0]
    zeros = lambda a: np.zeros_like(a)                          # noqa: E731
    t = torch.from_numpy
    full_calls = []
    blocked = topk.blocked_top_k

    def spy(x, kk, block=16):
        if x.shape[1] == r:
            full_calls.append(x.shape[0])
        return blocked(x, kk, block)
    monkeypatch.setattr(topk, "blocked_top_k", spy)
    got = scanstep._flush_merge(
        t(state_v), t(s_lo), t(zeros(s_lo)), t(buf_v), t(b_lo),
        t(zeros(b_lo)), t(sc), t(sc).view(3, -1, 16).amax(-1), t(row_lo),
        t(zeros(row_lo)), cand_k)
    assert full_calls == [1]
    cat_v = np.concatenate([state_v, buf_v, sc], axis=1)
    cat_lo = np.concatenate([s_lo, b_lo, np.tile(row_lo, (3, 1))], axis=1)
    o = np.argsort(-cat_v, axis=1, kind="stable")[:, :k]
    np.testing.assert_array_equal(got[0].numpy(),
                                  np.take_along_axis(cat_v, o, 1))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.take_along_axis(cat_lo, o, 1))
    assert not got[2].any()


@pytest.mark.parametrize("split", [10, 20])
def test_jax_midstream_state_continues_in_port(split):
    """A JAX BufferedTopKState taken mid-stream (its cand_w step on the
    XLA mirror) and continued by the port ends equal to JAX continuing."""
    y, batches = stream(21, p=3, n_batches=30)
    yp, ysum = jscore.prepare_phenotypes(y, N_PAD)
    kw = dict(n_used=N, min_count=MIN_COUNT, kernel="xla", cand_k=12,
              tile_rows=16, cand_w=8, cand_q=4)

    def jax_steps(st, part):
        for packed, pc, lo, hi in part:
            st = jss.scan_step_compact(st, jnp.asarray(packed),
                                       jnp.asarray(pc), jnp.asarray(lo),
                                       jnp.asarray(hi), yp, ysum, **kw)
        return st

    mid = jax_steps(jss.init_buffered_state(3, 16, buf_cap=24),
                    batches[:split])
    fields = {k: np.asarray(v) for k, v in mid._asdict().items()}
    st = convert.buffered_state_from_numpy(fields, "cpu")
    assert st.buf_n == int(fields["buf_n"])
    for name, arr in convert.to_numpy(st).items():
        np.testing.assert_array_equal(arr, fields[name])
    got_s, got_r = port_run(st, y, batches[split:], {}, tile_rows=16,
                            cand_w=8, cand_q=4)
    want = jss.flush_buffered(jax_steps(mid, batches[split:]))
    np.testing.assert_array_equal(got_s, np.asarray(want.scores))
    np.testing.assert_array_equal(
        got_r, jtopk.decode_rows(np.asarray(want.row_lo),
                                 np.asarray(want.row_hi)))
    plain = convert.topk_state_from_numpy(
        {k: np.asarray(v) for k, v in want._asdict().items()}, "cpu")
    np.testing.assert_array_equal(plain.scores.numpy(), got_s)
