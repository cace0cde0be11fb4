"""Parity of the port's scan steps (kmersgwas_tpu_torch.ops.scanstep) with
the JAX package on the CPU: tie-heavy streams (the streams of
tests/test_ops.py's cand_w and col_group tests, with dyadic phenotypes so
both sides' scores are bit-equal) must end in the same top-k — scores AND
rows — as the JAX package's plain `scan_step`, with the narrow, wide and
fallback branches all engaged; settled and flushed after every batch,
the step must equal the JAX plain step's state batch for batch; and a JAX
mid-stream state handed to the port (kmersgwas_tpu_torch.convert) must
end where JAX ends."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from kmersgwas_tpu.ops import bitplanes as jbits
from kmersgwas_tpu.ops import scanstep as jss
from kmersgwas_tpu.ops import score as jscore
from kmersgwas_tpu.ops import topk as jtopk
from kmersgwas_tpu_torch import convert, utils
from kmersgwas_tpu_torch.ops import bitplanes, scanstep, topk
from kmersgwas_tpu_torch.parallel import sharding
from kmersgwas_tpu_torch.pipeline import checkpoint as ckpt

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


@pytest.mark.parametrize("tie_column", [None, 1])
@pytest.mark.parametrize("tile_rows", [64, 16])
def test_step_stream_matches_jax(tile_rows, tie_column):
    y, batches = stream(33, p=3, n_batches=30, tie_column=tie_column)
    want_s, want_r = jax_plain_final(y, batches, k=16)
    counts = {}
    st = scanstep.init_buffered_state(3, 16, buf_cap=24, device="cpu")
    got_s, got_r = port_run(st, y, batches, counts, tile_rows=tile_rows,
                            cand_w=8, cand_q=4)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_r, want_r)
    assert counts.get("narrow", 0) >= 3, counts
    assert counts.get("fallback", 0) >= 1, counts
    # the tied stream's guards never need the wide append
    assert counts.get("wide", 0) >= (tie_column is None), counts


@pytest.mark.parametrize("tie_column,cand_k", [(None, 8), (1, 8), (1, None)])
def test_step_matches_jax_plain_after_every_batch(tie_column, cand_k):
    """The `cand_w` step, settled and flushed after every batch, against
    the JAX package's plain `scan_step(kernel="xla")` (cand_k its
    candidate cap, or none): the same top-k, scores and rows, after every
    batch, ties included; the step's narrow and fallback branches both
    run."""
    y, batches = stream(27, p=3, n_batches=24, tie_column=tie_column)
    k = 16
    jyp, jysum = jscore.prepare_phenotypes(y, N_PAD)
    jst = jtopk.init_state(3, k)
    yp, ysum = (torch.from_numpy(a) for a in _prep(y))
    st = scanstep.init_buffered_state(3, k, buf_cap=24, device="cpu")
    counts = {}
    for b in batches:
        packed, pc, lo, hi = b
        jst = jss.scan_step(jst, jnp.asarray(packed), jnp.asarray(pc),
                            jnp.asarray(lo), jnp.asarray(hi), jyp, jysum,
                            n_used=N, min_count=MIN_COUNT, kernel="xla",
                            cand_k=cand_k)
        scanstep.scan_step_compact(st, *port_batch(b), yp, ysum,
                                   counts=counts,
                                   **dict(_step_kw(), cand_k=cand_k or k))
        scanstep.settle(st)
        got = scanstep.flush_buffered(st)
        for name in ("scores", "row_lo", "row_hi"):
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          np.asarray(getattr(jst, name)))
    assert sum(counts.values()) - counts.get("flush", 0) == len(batches)
    assert counts.get("narrow", 0) >= 3, counts
    assert counts.get("fallback", 0) >= 1, counts


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


@pytest.mark.parametrize("mode,width", [(dict(cand_w=8), 8),
                                        (dict(cand_c=4), 12)],
                         ids=["cand_w", "cand_c"])
def test_stale_threshold_stream_matches_jax(mode, width):
    """A buffer one candidate width wide makes most steps flush or fall
    back, so most deferred applies raise the threshold that the next
    batch's guards have already read (`step.stale`): col_group 4 over
    P=10, with narrow and wide appends, in both
    candidate modes, must still end bit-equal to the JAX package's plain
    scan. Every batch but the last is applied by the next step, the last
    by the flush's settle."""
    y, batches = stream(35, p=10, n_batches=24, tie_column=2)
    want_s, want_r = jax_plain_final(y, batches, k=12)
    counts = {}
    st = scanstep.init_buffered_state(10, 12, buf_cap=width, device="cpu")
    with utils.tracing():
        got_s, got_r = port_run(st, y, batches, counts, tile_rows=16,
                                cand_q=4, col_group=4, **mode)
    np.testing.assert_array_equal(got_s, want_s)
    np.testing.assert_array_equal(got_r, want_r)
    c = utils.last_trace().counters
    assert c["step.deferred"] == len(batches) - 1, c
    assert c["step.settled"] == 1, c
    assert c["step.stale"] > 0, c
    assert counts.get("flush", 0) + counts.get("fallback", 0) \
        > len(batches) // 2, counts
    assert counts.get("narrow", 0) + counts.get("wide", 0) >= 5, counts


def _step_kw():
    return dict(n_used=N, min_count=MIN_COUNT, cand_k=12, tile_rows=16,
                cand_w=8, cand_q=4)


@pytest.mark.parametrize("form", ["plain", "buffered"])
def test_checkpoint_mid_stream_resumes_equal(tmp_path, form):
    """A checkpoint saved mid-stream holds the batch still pending: plain,
    the flushed top-k (associate's form) seeding a fresh state; buffered,
    the whole state (the multi-process scan's form, convert.to_numpy).
    Resumed, it ends equal to the uninterrupted run, and so does the run
    that saved it and went on."""
    y, batches = stream(21, p=3, n_batches=30)
    yp, ysum = (torch.from_numpy(a) for a in _prep(y))
    whole = scanstep.init_buffered_state(3, 16, buf_cap=24, device="cpu")
    want = port_run(whole, y, batches, {}, tile_rows=16, cand_w=8, cand_q=4)
    st = scanstep.init_buffered_state(3, 16, buf_cap=24, device="cpu")
    for b in batches[:13]:
        scanstep.scan_step_compact(st, *port_batch(b), yp, ysum, **_step_kw())
    assert st.pending is not None
    path = str(tmp_path / "ck")
    meta = {"n_used": N}
    if form == "plain":
        ckpt.save_scan_state(path, scanstep.flush_buffered(st), 13 * ROWS,
                             13 * ROWS, stream="stream", meta=meta)
        plain = ckpt.load_scan_state(path, meta=meta)[0]
        resumed = sharding.init_sharded_buffered_state(
            sharding.make_mesh(["cpu"]), 3, 16, 24, seed_state=plain)[0]
    else:
        ckpt.save_distributed_state(path, st, 13 * ROWS, 13 * ROWS,
                                    "stream", meta)
        resumed = ckpt.load_distributed_state(path, "stream", meta, "cpu")[0]
    assert st.pending is None
    for run in (resumed, st):
        got = port_run(run, y, batches[13:], {}, tile_rows=16, cand_w=8,
                       cand_q=4)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_mesh_finalize_settles_every_shard():
    """finalize_sharded_buffered over a 2-shard CPU mesh (the mesh step:
    every shard's kernel queued, then every shard's previous batch
    applied) applies each shard's pending batch and equals one shard."""
    y, batches = stream(33, p=3, n_batches=20)
    yp, ysum = (torch.from_numpy(a) for a in _prep(y))
    finals = []
    for devices in (["cpu"], ["cpu", "cpu"]):
        mesh = sharding.make_mesh(devices)
        states = sharding.init_sharded_buffered_state(mesh, 3, 16, 24)
        counts = {}
        step = sharding.build_sharded_scan_step_compact(
            mesh, counts=counts, **_step_kw())
        yps, ysums = sharding.replicate(mesh, yp, ysum)
        for b in batches:
            step(states, *sharding.shard_batch(mesh, list(port_batch(b))),
                 yps, ysums)
        assert all(st.pending is not None for st in states)
        finals.append(sharding.finalize_sharded_buffered(states))
        assert all(st.pending is None for st in states)
        assert sum(counts.get(k, 0) for k in ("narrow", "wide", "fallback")
                   ) == len(batches) * len(devices), counts
    for (gv, gr), (wv, wr) in zip(*finals):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gr, wr)


def test_flush_settles_once_and_counts_every_batch():
    """flush_buffered applies the pending batch: a second flush gives the
    same answer, and after it the branch counts sum to the batches."""
    y, batches = stream(33, p=3, n_batches=30)
    yp, ysum = (torch.from_numpy(a) for a in _prep(y))
    st = scanstep.init_buffered_state(3, 16, buf_cap=24, device="cpu")
    counts = {}
    for b in batches:
        scanstep.scan_step_compact(st, *port_batch(b), yp, ysum,
                                   counts=counts, **_step_kw())
    assert sum(counts.get(k, 0) for k in ("narrow", "wide", "fallback")
               ) == len(batches) - 1, counts
    first = scanstep.flush_buffered(st)
    assert sum(counts.get(k, 0) for k in ("narrow", "wide", "fallback")
               ) == len(batches), counts
    second = scanstep.flush_buffered(st)
    for a, b in zip(first, second):
        assert torch.equal(a, b)
    assert sum(counts.get(k, 0) for k in ("narrow", "wide", "fallback")
               ) == len(batches), counts


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


def test_fallback_pieces_run_in_named_profiler_ranges():
    """A fallback step's pieces show in torch.profiler as ranges
    kgt::<name>, each inside the one that calls it: the step, its
    candidate half (K1's call inside it), the flags' wait, and inside
    compact_apply K2's call and _flush_merge with top_k_from_bmax inside
    it, the names chip_smoke.py splits a fallback by. A batch is applied
    one call late: the first call only queues batch 0, whose apply (a
    fallback: the threshold starts at -inf) runs in the second call, after
    batch 1's candidates are queued."""
    from torch.profiler import ProfilerActivity, profile
    y, batches = stream(33, p=3, n_batches=2)
    yp, ysum = (torch.from_numpy(a) for a in _prep(y))
    st = scanstep.init_buffered_state(3, 16, buf_cap=24, device="cpu")
    counts = {}
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for b in batches:
            scanstep.scan_step_compact(st, *port_batch(b), yp, ysum,
                                       n_used=N, min_count=MIN_COUNT,
                                       cand_k=12, tile_rows=16, cand_w=8,
                                       cand_q=4, counts=counts)
    assert counts == {"fallback": 1}, counts
    assert st.pending is not None
    scanstep.settle(st)
    assert st.pending is None and sum(counts.values()) == 2, counts
    kgt = [e for e in prof.events() if e.name.startswith("kgt::")]
    first, second = sorted((e.time_range for e in kgt
                            if e.name == "kgt::scan_step_compact"),
                           key=lambda r: r.start)

    def inside(r):
        return [e for e in kgt if r.start <= e.time_range.start
                and e.time_range.end <= r.end]
    assert sorted(e.name for e in inside(first)) == [
        "kgt::compact_candidates", "kgt::scan_step_compact",
        "kgt::score_batch_t_topw"]
    events = {e.name: e for e in inside(second)}
    parent = {"compact_candidates": "scan_step_compact",
              "score_batch_t_topw": "compact_candidates",
              "step_flags": "scan_step_compact",
              "compact_apply": "scan_step_compact",
              "score_batch_t_bmax": "compact_apply",
              "_flush_merge": "compact_apply",
              "top_k_from_bmax": "_flush_merge"}
    assert set(events) == {f"kgt::{n}" for n in
                           {"scan_step_compact", *parent}}
    for inner, outer in parent.items():
        i, o = (events[f"kgt::{n}"].time_range for n in (inner, outer))
        assert o.start <= i.start and i.end <= o.end, (inner, outer)
    order = [events[f"kgt::{n}"].time_range for n in
             ("compact_candidates", "step_flags", "compact_apply")]
    assert all(a.end <= b.start for a, b in zip(order, order[1:]))


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


@pytest.mark.parametrize("rows", [300, 12])
def test_topk_init_state_and_update_match_jax(rows):
    """topk.init_state and three topk.update merges (rows > K: the blocked
    top-k; rows <= K: the whole batch) on tie-heavy non-negative scores
    with -inf lanes equal the JAX functions: scores and rows, exactly."""
    rng = np.random.default_rng(rows)
    p, k = 4, 20
    st, jst = topk.init_state(p, k), jtopk.init_state(p, k)
    for name, a in zip(st._fields, st):
        np.testing.assert_array_equal(a.numpy(),
                                      np.asarray(getattr(jst, name)))
    for b in range(3):
        # squares, as scores are: no -0 (lax.top_k ranks +0 above -0)
        sc = (np.round(rng.normal(size=(rows, p)) * 2) ** 2).astype(
            np.float32)
        sc[rng.random((rows, p)) < 0.1] = -np.inf
        lo, hi = jtopk.encode_rows(np.arange(b * rows, (b + 1) * rows)
                                   + (1 << 30))
        jst = jtopk.update(jst, jnp.asarray(sc), jnp.asarray(lo),
                           jnp.asarray(hi))
        st = topk.update(st, torch.from_numpy(sc), torch.from_numpy(lo),
                         torch.from_numpy(hi))
        for name, a in zip(st._fields, st):
            np.testing.assert_array_equal(a.numpy(),
                                          np.asarray(getattr(jst, name)))
