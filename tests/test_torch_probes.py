"""K8 and the probe tool (kmersgwas_tpu_torch.tools.probes) on the CPU
against the JAX package, at small shapes; every comparison is exact.

  * K8: `parity_plain` against a numpy replica of tools/prof_r5_epi.py's
    `_parity_kernel` (:443-491; the kernel is a closure there, so a replica
    is the only way to reach it) at shapes where both lists evict; and,
    where no list evicts, lists A and B together against the JAX
    `score_batch_t_pallas_topw` list in interpret mode;
  * every distinct step configuration of VARIANTS, cut to a tiny depth
    (N 64; rows per step, P, the candidate widths, the buffer and col_group
    cut in proportion), through the probes' window (`bench.make_window`)
    against the JAX `scan_step_compact` fed the same generated planes: the
    same flushed top-k, scores bit-equal on dyadic phenotypes;
  * each kind of timed window on the CPU, `main`'s deduplication and the
    CLI.

The JAX kernels sum-encode a tile's 2nd and 3rd lanes; the port's lanes
are exact. So lanes are compared where the reference's are exact (ROADMAP
§C, known item 2)."""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kmersgwas_tpu.ops import scanstep as jss
from kmersgwas_tpu.ops import score as jscore
from kmersgwas_tpu.ops import topk as jtopk
from kmersgwas_tpu_torch import bench
from kmersgwas_tpu_torch.ops import bitplanes, score
from kmersgwas_tpu_torch.ops import gen as gen_ops
from kmersgwas_tpu_torch.ops import scanstep as ss
from kmersgwas_tpu_torch.ops import topk
from kmersgwas_tpu_torch.tools import probes

N, N_PAD, MIN_COUNT = 64, 128, 3


def dyadic(rng, shape):
    return (np.round(rng.uniform(-8, 8, size=shape) * 8) / 8).astype(
        np.float32)


def batch(seed, rows, p, pad_rows=0):
    """Random presence bits (the last pad_rows rows padding), dyadic
    phenotypes -> (packed uint32 (R, W32), popcounts, y)."""
    rng = np.random.default_rng(seed)
    bits = np.zeros((rows, N_PAD), np.uint8)
    bits[:, :N] = rng.integers(0, 2, size=(rows, N))
    if pad_rows:
        bits[rows - pad_rows:] = 0
    return (bitplanes.pack_bits_np(bits), bits.sum(1).astype(np.float32),
            dyadic(rng, (N, p)))


def jax_scores(packed, pc, y):
    yp, ysum = jscore.prepare_phenotypes(y, N_PAD)
    return np.asarray(jss._scores_t_xla(jnp.asarray(packed), jnp.asarray(pc),
                                        yp, ysum, N, MIN_COUNT))


def port_parity(packed, pc, y, th, tile_rows, w):
    yp, ysum = score.prepare_phenotypes(y, N_PAD, "cpu")
    out = score.score_batch_t_parity(
        bitplanes.as_planes(packed), torch.from_numpy(pc), yp, ysum,
        torch.from_numpy(th), n_used=N, min_count=MIN_COUNT,
        tile_rows=tile_rows, w=w)
    return [t.numpy() for t in out]


def parity_replica(sc, th, tile_rows, w):
    """tools/prof_r5_epi.py:443-491 in numpy on scores sc (P, R): per tile
    m1/a1 (first argmax), the arithmetic-masked m2/n2/a2 and m3/n3/a3 with
    sum-encoded lanes, the hot count and guard; even tiles replace-min into
    list A, odd ones into list B. -> ([(v, g, exact)] for A and B, ok);
    exact marks the entries whose lane is not sum-encoded over ties."""
    p, r = sc.shape
    idx = np.arange(tile_rows)
    idx_f = idx.astype(np.float32)
    lists = [(np.full((p, w), -np.inf, np.float32), np.zeros((p, w), np.int32),
              np.zeros((p, w), bool)) for _ in range(2)]
    ok = np.ones(p, bool)
    cols = np.arange(p)
    with np.errstate(over="ignore", invalid="ignore"):
        for t in range(r // tile_rows):
            s = sc[:, t * tile_rows:(t + 1) * tile_rows]
            m1, a1 = s.max(1), s.argmax(1)
            big = (idx == a1[:, None]).astype(np.float32) * np.float32(-3e38)
            s2 = s + big + big
            m2 = s2.max(1)
            eq2 = (s2 == m2[:, None]).astype(np.float32)
            n2 = eq2.sum(1).astype(np.int32)
            a2 = np.minimum((idx_f * eq2).sum(1).astype(np.int32),
                            tile_rows - 1)
            big2 = (idx == a2[:, None]).astype(np.float32) * np.float32(-3e38)
            s3 = s2 + big2 + big2
            m3 = s3.max(1)
            eq3 = (s3 == m3[:, None]).astype(np.float32)
            n3 = eq3.sum(1).astype(np.int32)
            a3 = np.minimum((idx_f * eq3).sum(1).astype(np.int32),
                            tile_rows - 1)
            cnt = (s > th[:, None]).sum(1)
            ok &= ((cnt <= 3) & ((m2 <= th) | (n2 == 1))
                   & ((m3 <= th) | (n3 == 1)))
            lv, lg, lx = lists[t % 2]
            for m, a, exact in ((m1, a1, np.ones(p, bool)), (m2, a2, n2 == 1),
                                (m3, a3, (n2 == 1) & (n3 == 1))):
                am = lv.argmin(1)
                hit = m > lv[cols, am]
                lv[cols[hit], am[hit]] = m[hit]
                lg[cols[hit], am[hit]] = t * tile_rows + a[hit]
                lx[cols[hit], am[hit]] = exact[hit]
    return lists, ok


@pytest.mark.parametrize("th_kind", ["quantile", "+inf"])
@pytest.mark.parametrize("seed", [0, 1])
def test_parity_plain_matches_the_replica(seed, th_kind):
    p, tile_rows, w, n_tiles = 10, 32, 8, 64
    rows = tile_rows * n_tiles
    packed, pc, y = batch(seed, rows, p, pad_rows=2 * tile_rows + 5)
    sc = jax_scores(packed, pc, y)
    th = np.full(p, np.inf, np.float32) if th_kind == "+inf" else \
        np.quantile(sc, 0.97, axis=1).astype(np.float32)
    va, ga, vb, gb, ok = port_parity(packed, pc, y, th, tile_rows, w)
    (la, lb), rok = parity_replica(sc, th, tile_rows, w)
    tiles = sc.reshape(p, n_tiles, tile_rows)
    top3 = -np.sort(-tiles, axis=2)[:, :, :3]          # every tile's top-3
    cnt = (tiles > th[:, None, None]).sum(2)
    np.testing.assert_array_equal(ok, (cnt <= 3).all(1))
    assert not (rok & ~ok).any()           # the replica's guard is stricter
    if th_kind == "quantile":
        assert (~ok).any() and ok.any()
    for (v, g), (rv, rg, rx), parity in (((va, ga), la, 0), ((vb, gb), lb, 1)):
        np.testing.assert_array_equal(v, -np.sort(-rv, axis=1))
        pool = top3[:, parity::2].reshape(p, -1)
        for c in range(p):
            cut = v[c, -1]
            assert np.isfinite(cut)                        # the lists evict
            # lanes are determined wherever the cut value is not contested
            contested = (pool[c] == cut).sum() > (v[c] == cut).sum()
            keep = rx[c] & ((rv[c] > cut) | ~contested)
            assert keep.sum() >= w // 2
            want = set(zip(rv[c][keep].tolist(), rg[c][keep].tolist()))
            assert want <= set(zip(v[c].tolist(), g[c].tolist()))


def test_parity_without_eviction_is_the_topw_list():
    """64 tiles of 32 rows: 96 candidates per list (w = 128) and 192 in
    the JAX list (cand_w = 256), so no list evicts: A and B together hold
    the JAX kernel's candidates."""
    p, tile_rows, n_tiles = 10, 32, 64
    rows = tile_rows * n_tiles
    packed, pc, y = batch(5, rows, p)
    sc = jax_scores(packed, pc, y)
    th = np.quantile(sc, 0.97, axis=1).astype(np.float32)
    va, ga, vb, gb, ok = port_parity(packed, pc, y, th, tile_rows, 128)
    yp, ysum = jscore.prepare_phenotypes(y, N_PAD)
    with pltpu.force_tpu_interpret_mode():
        cv, cg, jok = jscore.score_batch_t_pallas_topw(
            jnp.asarray(packed), jnp.asarray(pc), yp, ysum, jnp.asarray(th),
            n_used=N, min_count=MIN_COUNT, tile_rows=tile_rows, cand_w=256)
    cv, cg, jok = np.asarray(cv), np.asarray(cg), np.asarray(jok)
    assert not (jok & ~ok).any()
    tiles = sc.reshape(p, n_tiles, tile_rows)
    for c in range(p):
        pv = np.concatenate([va[c], vb[c]])
        pg = np.concatenate([ga[c], gb[c]])
        fin, jfin = np.isfinite(pv), np.isfinite(cv[c])
        np.testing.assert_array_equal(np.sort(pv[fin]), np.sort(cv[c][jfin]))

        def unique_in_tile(vs, gs):
            t = gs // tile_rows
            return {(v, g) for v, g, tt in zip(vs.tolist(), gs.tolist(), t)
                    if (tiles[c, tt] == v).sum() == 1}
        assert unique_in_tile(pv[fin], pg[fin]) \
            == unique_in_tile(cv[c][jfin], cg[c][jfin])


# ------------------------------------------------------------- the steps

ROW_SHIFT = 9       # 2^21-row steps -> 4096 rows (32 of the port's tiles)
CUT = 16            # P, col_group, the candidate widths and the buffer
K_SMALL, CAND_K_SMALL = 12, 128


def cut(x):
    return None if x is None else max(1, x // CUT)


def shrink(v: probes.Variant, **kw) -> probes.Variant:
    """The variant at a tiny depth, in proportion."""
    return dataclasses.replace(
        v, p=-(-v.p // CUT), rows=v.rows >> ROW_SHIFT, cand_w=cut(v.cand_w),
        cand_c=cut(v.cand_c), cand_c2=cut(v.cand_c2), cand_q=cut(v.cand_q),
        col_group=v.col_group // CUT, buf_cap=cut(v.buf_cap),
        w=max(v.w // CUT, 1), tile_rows=max(v.tile_rows >> ROW_SHIFT, 4),
        **kw)


def step_configs():
    seen = {}
    for v in probes.VARIANTS:
        if v.timed == "step":
            s = shrink(v)
            key = (s.p, s.rows, s.buf_cap, tuple(sorted(s.step_kw().items())))
            seen.setdefault(key, f"{v.probe}/{v.name}")
    return sorted(seen.values())


@pytest.mark.parametrize("name", step_configs())
def test_step_configuration_matches_jax(name, monkeypatch):
    monkeypatch.setattr(probes, "CAND_K", CAND_K_SMALL)
    v = shrink(probes.variant(*name.split("/")))
    seed, steps = 11, 10
    y = dyadic(np.random.default_rng(seed), (N, v.p))
    yp, ysum = score.prepare_phenotypes(y, N_PAD, "cpu")
    counts = {}
    window = bench.make_window(yp, ysum, n_used=N, min_count=MIN_COUNT,
                               rows=v.rows, steps=steps, seed=seed,
                               popcount=v.popcount, counts=counts,
                               **v.step_kw())
    state = ss.init_buffered_state(v.p, K_SMALL, v.buf_cap, "cpu")
    assert window(state, 0) == steps
    got = ss.flush_buffered(state)

    kw = {k: val for k, val in v.step_kw().items() if val is not None}
    jyp, jysum = jscore.prepare_phenotypes(y, N_PAD)
    jst = jss.init_buffered_state(v.p, K_SMALL, buf_cap=v.buf_cap)
    for s in range(steps):
        planes, pc = gen_ops.gen_planes_plain(torch.arange(v.rows),
                                              N_PAD // 32, seed, s)
        jst = jss.scan_step_compact(
            jst, jnp.asarray(np.ascontiguousarray(
                planes.numpy().view(np.uint32).T)),
            jnp.asarray(pc.numpy()),
            jnp.arange(s * v.rows, (s + 1) * v.rows, dtype=jnp.int32),
            jnp.zeros(v.rows, jnp.int32), jyp, jysum, n_used=N,
            min_count=MIN_COUNT, kernel="xla", tile_rows=probes.TILE,
            pre_transposed=True, **kw)
    want = jss.flush_buffered(jst)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(
        topk.decode_rows(got.row_lo.numpy(), got.row_hi.numpy()),
        jtopk.decode_rows(np.asarray(want.row_lo), np.asarray(want.row_hi)))
    # both branches ran: a fallback, and an append (with several column
    # groups a step that appends for some groups counts as a fallback)
    assert counts.get("fallback", 0) >= 1, counts
    assert counts.get("narrow", 0) + counts.get("wide", 0) >= 1 \
        or state.buf_n > 0, (counts, state.buf_n)


# ------------------------------------------------------------- the tool

KINDS = ["prof_r3/latency", "prof_r3/gen", "prof_window/w0",
         "prof_r3/score", "prof_r3/tilemax", "prof_r5_epi/topwfloor",
         "prof_r5_epi/parity4096", "prof_window2/p0", "prof_window2/p3",
         "prof_r5_pscale/1009", "prof_r4/v0"]


@pytest.fixture
def tiny(monkeypatch):
    for k, val in dict(N_USED=N, N_PAD=N_PAD, K=K_SMALL, MIN_COUNT=MIN_COUNT,
                       CAND_K=CAND_K_SMALL).items():
        monkeypatch.setattr(probes, k, val)


@pytest.mark.parametrize("name", KINDS)
def test_each_timed_kind_runs_on_the_cpu(name, tiny, capsys):
    v = shrink(probes.variant(*name.split("/")), s=2, n_warm=1,
               n_windows=2)
    v = dataclasses.replace(v, n_ramp=min(v.n_ramp, 2))
    run = probes.run_variant(v, device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == run.record
    assert (printed["probe"], printed["variant"]) == tuple(name.split("/"))
    if v.timed == "latency":
        assert printed["synced_launch_ms"] > 0
        return
    assert printed["device"] == "cpu" and printed["median_step_ms"] > 0
    assert len(printed["window_ms"]) == 2
    assert printed["tests_per_s"] == pytest.approx(
        printed["rows_per_s"] * v.p)
    if v.timed == "step":
        assert run.steps == 2 * (1 + v.n_ramp + 2)
        branches = dict(printed["branches"])
        for k, n in printed["ramp_branches"].items():
            branches[k] = branches.get(k, 0) + n
        assert sum(branches.values()) >= run.steps - 2   # the warm window
        assert torch.isfinite(ss.flush_buffered(run.state).scores[:, 0]).all()


def test_variants_cover_every_probe():
    assert set(probes.PROBES) == {
        "prof_r3", "prof_r4", "prof_r4b", "prof_r5_feed", "prof_pscale",
        "prof_r5_pscale", "prof_r5_pcpad", "prof_window", "prof_window2",
        "prof_r5_epi"}
    assert set(probes.HEADLINE) == set(probes.PROBES)
    for probe, name in probes.HEADLINE.items():
        probes.variant(probe, name)
    names = [(v.probe, v.name) for v in probes.VARIANTS]
    assert len(names) == len(set(names))
    big = probes.variant("prof_r5_pscale", "1009")
    assert (big.p, big.col_group, big.cand_w, big.rows) == (1009, 128, 256,
                                                            1 << 20)
    assert all(v.rows * v.s * (v.n_warm + v.n_ramp + v.n_windows)
               <= bench.ROW_ID_LIMIT for v in probes.VARIANTS)


def test_main_runs_each_configuration_once(monkeypatch, capsys):
    ran = []

    def fake(v, dev, card):
        ran.append((v.probe, v.name))
        return probes.ProbeRun({"probe": v.probe, "variant": v.name})
    monkeypatch.setattr(probes, "run_variant", fake)
    out = probes.main("all", device="cpu")
    assert len(out) == len(probes.VARIANTS)
    same = [r for r in out if "same_as" in r]
    assert len(ran) + len(same) == len(probes.VARIANTS)
    assert ("prof_r4", "v1") in ran and ("prof_r4", "v2") not in ran
    assert {"probe": "prof_r4", "variant": "v2", "same_as": "prof_r4 v1",
            "note": ""} in same
    ran.clear()
    probes.main("prof_pscale", ["1013"], device="cpu")
    assert ran == [("prof_pscale", "1013")]
    lines = capsys.readouterr().out.strip().splitlines()
    assert [json.loads(ln) for ln in lines] == same


def test_cli(monkeypatch):
    calls = []
    monkeypatch.setattr(probes, "main",
                        lambda *a, **kw: calls.append((a, kw)))
    probes._cli(["prof_r4", "v1", "v3", "--device", "cpu"])
    probes._cli(["all"])
    assert calls == [(("prof_r4", ["v1", "v3"]), {"device": "cpu"}),
                     (("all", []), {"device": "cuda"})]
    for argv in (["nosuch"], ["all", "v1"]):
        with pytest.raises(SystemExit):
            probes._cli(argv)
