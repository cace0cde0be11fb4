"""The port's bench and at-scale stream (kmersgwas_tpu_torch.bench,
kmersgwas_tpu_torch.tools.at_scale_stream) on the CPU at small shapes,
against the JAX package where it computes the same thing:

  * the bench's window loop on generated planes against the JAX scan step
    (`scan_step_compact(kernel="xla", cand_w=..., pre_transposed=True)`)
    fed the same planes transposed: the same rows in every column, scores
    bit-equal on dyadic phenotypes;
  * `main` at a shrunk shape (JSON keys, finite checksum, kept rows
    regenerated and re-scored in f64);
  * the at-scale stream from just under 2^31: continuous against
    checkpoint + resume bit for bit, the planted ids recovered, the
    checkpoint loaded by the JAX package's `load_scan_state`;
  * `streaming` and `kinship_streaming` on a tiny table (the JSON keys,
    n_tested against the JAX `associate`)."""
import json
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmersgwas_tpu.ops import scanstep as jss
from kmersgwas_tpu.ops import score as jscore
from kmersgwas_tpu.ops import topk as jtopk
from kmersgwas_tpu.pipeline import checkpoint as jckpt
from kmersgwas_tpu.pipeline import scan as jscan
from kmersgwas_tpu_torch import bench
from kmersgwas_tpu_torch.ops import gen as gen_ops
from kmersgwas_tpu_torch.ops import scanstep as ss
from kmersgwas_tpu_torch.ops import score as score_ops
from kmersgwas_tpu_torch.ops import topk
from kmersgwas_tpu_torch.pipeline import checkpoint as ckpt
from kmersgwas_tpu_torch.tools import at_scale_stream as ats

N, N_PAD, P, K, ROWS, STEPS = 120, 128, 5, 64, 4096, 12
SMALL = dict(cand_w=16, cand_k=32, cand_q=4)
BUF = 64


def dyadic(seed, shape):
    rng = np.random.default_rng(seed)
    return (np.round(rng.uniform(-8, 8, size=shape) * 8) / 8).astype(
        np.float32)


@pytest.mark.parametrize("seed", [3, 4])
def test_window_loop_matches_jax_scan_step(seed):
    y = dyadic(seed, (N, P))
    min_count = 5
    yp, ysum = score_ops.prepare_phenotypes(y, N_PAD, "cpu")
    counts = {}
    window = bench.make_window(yp, ysum, n_used=N, min_count=min_count,
                               rows=ROWS, steps=STEPS, seed=seed,
                               counts=counts, **SMALL)
    state = ss.init_buffered_state(P, K, BUF, "cpu")
    assert window(state, 0) == STEPS
    got = ss.flush_buffered(state)

    jyp, jysum = jscore.prepare_phenotypes(y, N_PAD)
    jst = jss.init_buffered_state(P, K, buf_cap=BUF)
    for s in range(STEPS):
        planes, pc = gen_ops.gen_planes_plain(torch.arange(ROWS), N_PAD // 32,
                                              seed, s)
        packed_t = np.ascontiguousarray(planes.numpy().view(np.uint32).T)
        lo = np.arange(s * ROWS, (s + 1) * ROWS, dtype=np.int32)
        jst = jss.scan_step_compact(
            jst, jnp.asarray(packed_t), jnp.asarray(pc.numpy()),
            jnp.asarray(lo), jnp.zeros(ROWS, jnp.int32), jyp, jysum,
            n_used=N, min_count=min_count, kernel="xla", tile_rows=512,
            pre_transposed=True, **SMALL)
    want = jss.flush_buffered(jst)
    np.testing.assert_array_equal(got.scores.numpy(), np.asarray(want.scores))
    np.testing.assert_array_equal(
        topk.decode_rows(got.row_lo.numpy(), got.row_hi.numpy()),
        jtopk.decode_rows(np.asarray(want.row_lo), np.asarray(want.row_hi)))
    assert counts.get("fallback", 0) >= 1, counts
    assert counts.get("narrow", 0) + counts.get("wide", 0) >= 1, counts


def test_window_refuses_row_ids_past_2p31():
    yp, ysum = score_ops.prepare_phenotypes(dyadic(0, (N, P)), N_PAD, "cpu")
    window = bench.make_window(yp, ysum, n_used=N, min_count=5, rows=ROWS,
                               steps=2, **SMALL)
    with pytest.raises(ValueError, match="2\\^31"):
        window(ss.init_buffered_state(P, K, BUF, "cpu"),
               (1 << 31) // ROWS - 1)


def test_main_small(monkeypatch, tmp_path, capsys):
    for name, v in dict(N_USED=N, N_PAD=N_PAD, P=P, K=K, ROWS=ROWS,
                        BUF_CAP=bench.CAND_W * 2).items():
        monkeypatch.setattr(bench, name, v)
    line, run = bench.main(n_windows=3, steps_per_window=2, n_ramp=6,
                           device="cpu", feed_rows=30_000,
                           workdir=str(tmp_path))
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {
        "metric", "value", "unit", "vs_baseline", "window_spread_p10_p90",
        "median_step_ms", "mfu", "gemm_floor_ms", "ramp_window_ms",
        "host_feed_rows_per_sec_warm",
        "host_feed_rows_per_sec_warm_512k_batch",
        "host_feed_rows_per_sec_cold", "disk_seq_read_gb_per_sec",
        "colocated_end_to_end_kmers_per_sec_bound"}
    assert line["mfu"] is None and "no bf16 peak" in line["unit"]
    assert 6 <= len(line["ramp_window_ms"]) <= 24
    assert run.steps == 2 * (1 + len(line["ramp_window_ms"]) + 3)
    assert math.isfinite(float(run.state.scores[:, 0].sum()))
    # every kept row of column 0, regenerated alone from (seed, step, r),
    # scores as kept up to f32 summation order (the smoke holds the f64
    # re-score to CERTIFY_EPS at N=1008 on ~1.3e9 rows; at this size the
    # bf16-rounded phenotypes of precision "default" can exceed it)
    final = ss.flush_buffered(run.state)
    rows = topk.decode_rows(final.row_lo.numpy(), final.row_hi.numpy())[0]
    step, r = np.divmod(rows, ROWS)
    planes, pc = gen_ops.gen_planes_plain(torch.from_numpy(r), N_PAD // 32,
                                          run.seed, torch.from_numpy(step))
    yp, ysum = score_ops.prepare_phenotypes(run.y, N_PAD, "cpu")
    again = score_ops.scores_t_plain(planes, pc, yp, ysum, n_used=N,
                                     min_count=bench.MIN_COUNT)[0]
    bits = np.unpackbits(planes.numpy().view(np.uint8), axis=1,
                         bitorder="little").astype(np.float64)
    y0 = np.zeros(N_PAD)
    y0[:N] = run.y[:, 0]
    n1 = pc.numpy().astype(np.float64)
    num = N * (bits @ y0) - n1 * y0.sum()
    exact = num * num / (N * n1 - n1 * n1)
    kept = final.scores[0].numpy()
    assert np.isfinite(kept).all()
    np.testing.assert_allclose(kept, again.numpy(), rtol=1e-5)
    np.testing.assert_allclose(kept, exact, rtol=1e-2)


def test_main_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench.main(device="cuda")


AT_SCALE = dict(n_used=248, n_pad=256, p=5, k=64, rows=ROWS, min_count=5,
                steps_per_window=2, total_steps=12, ckpt_window=2,
                n_causal=3, first_row=2**31 - 5 * ROWS - 123, buf_cap=BUF,
                **SMALL)


@pytest.fixture(scope="module")
def at_scale(tmp_path_factory):
    out = tmp_path_factory.mktemp("at_scale") / "result.json"
    res = ats.main(device="cpu", out=str(out), **AT_SCALE)
    return res, out


def test_at_scale_resume_is_bit_exact(at_scale):
    res, out = at_scale
    assert json.loads(out.read_text()) == res
    assert res["resume_bit_exact"]
    assert res["total_rows"] == 12 * ROWS


def test_at_scale_recovers_planted_ids_past_2p31(at_scale):
    res, _ = at_scale
    assert res["recovered"] == res["planted_ids"]
    assert all(i > 2**31 for i in res["planted_ids"])
    assert res["planted_scores_match_host_f64"]
    assert res["max_row_exceeds_2p31"]
    # the stream began under 2^31 and below the hi = 2 split: the ids of
    # the top-k span the 2^30 boundary
    assert AT_SCALE["first_row"] < 2 * 2**30 < res["max_row_id_in_topk"]


def test_at_scale_checkpoint_loads_in_the_jax_package(at_scale):
    _, out = at_scale
    path = str(out.with_suffix(".ckpt"))
    kw = AT_SCALE
    meta = {"total_rows": 12 * ROWS, "n_used": kw["n_used"],
            "min_count": kw["min_count"], "k": kw["k"], "p": kw["p"]}
    jstate, jnext, jtested, jstream = jckpt.load_scan_state(path, meta=meta)
    done = (kw["ckpt_window"] + 1) * kw["steps_per_window"] * ROWS
    assert (jnext, jtested, jstream) == (kw["first_row"] + done, done,
                                         "stream")
    # the port's flush after the checkpoint window, recomputed
    port_state = ckpt.load_scan_state(path, meta=meta)[0]
    for a, b in zip(jstate, port_state):
        np.testing.assert_array_equal(np.asarray(a), b)
    stream, fresh = at_scale_stream(kw)
    flushed, _ = stream.run(fresh, 0, kw["ckpt_window"] + 1, "t")
    for a, b in zip(jstate, flushed):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def at_scale_stream(kw):
    """A Stream and a fresh state built as main builds them (same draws)."""
    ids, _, words, pc, y = ats.draw(
        seed=7, n_used=kw["n_used"], w32=kw["n_pad"] // 32, p=kw["p"],
        n_causal=kw["n_causal"], beta=3.0, first_row=kw["first_row"],
        end_row=kw["first_row"] + kw["total_steps"] * kw["rows"])
    yp, ysum = score_ops.prepare_phenotypes(y, kw["n_pad"], "cpu")
    stream = ats.Stream(
        yp, ysum, words, pc, ids, n_used=kw["n_used"],
        min_count=kw["min_count"], rows=kw["rows"],
        steps_per_window=kw["steps_per_window"], first_row=kw["first_row"],
        seed=ats.GEN_SEED, cand_w=kw["cand_w"], cand_k=kw["cand_k"],
        cand_q=kw["cand_q"])
    return stream, ss.init_buffered_state(kw["p"], kw["k"], kw["buf_cap"],
                                          "cpu")


def test_at_scale_refuses_a_stream_below_2p31(tmp_path):
    kw = dict(AT_SCALE, first_row=0)
    with pytest.raises(ValueError, match="2\\^31"):
        ats.main(device="cpu", out=str(tmp_path / "r.json"), **kw)


@pytest.fixture(scope="module")
def tiny_table(tmp_path_factory):
    workdir = str(tmp_path_factory.mktemp("bench_pop"))
    return workdir, bench._synthetic_pop(20_000, workdir)


def test_streaming_matches_jax_associate(tiny_table, capsys):
    workdir, (base, _, names, n, kmer_len) = tiny_table
    line = bench.streaming(n_rows=20_000, batch_size=4096, workdir=workdir,
                           device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {
        "metric", "value", "unit", "vs_baseline",
        "host_feed_rows_per_sec_warm",
        "host_feed_rows_per_sec_warm_512k_batch",
        "host_feed_rows_per_sec_cold", "disk_seq_read_gb_per_sec",
        "sub_stage_seconds"}
    y = np.random.default_rng(1).normal(size=(n, bench.P))
    ref = jscan.associate(base, names, y, [f"c{j}" for j in range(bench.P)],
                          kmer_len=kmer_len, n_top=10, maf=0.05, mac=5,
                          batch_size=4096)
    assert line["n_tested"] == ref.n_tested > 0


def test_kinship_streaming_small(tiny_table, capsys):
    workdir, _ = tiny_table
    line = bench.kinship_streaming(n_rows=20_000, batch_size=4096,
                                   workdir=workdir, device="cpu")
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == line
    assert set(line) == {"metric", "value", "unit",
                         "host_feed_cold_cache_rows_per_sec",
                         "end_to_end_rows_per_sec"}
    assert line["value"] > 0 and line["end_to_end_rows_per_sec"] > 0


def test_cli_parses_its_modes(monkeypatch):
    calls = []
    for name in ("main", "streaming", "kinship_streaming"):
        monkeypatch.setattr(bench, name,
                            lambda name=name, **kw: calls.append((name, kw)))
    bench._cli(["--device", "cpu"])
    bench._cli(["--streaming", "--device", "cpu"])
    bench._cli(["--kinship-streaming"])
    assert calls == [("main", {"device": "cpu"}),
                     ("streaming", {"device": "cpu"}),
                     ("kinship_streaming", {"device": "cuda"})]
    with pytest.raises(SystemExit):
        bench._cli(["--streaming", "--kinship-streaming"])
