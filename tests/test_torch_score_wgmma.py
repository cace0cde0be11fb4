"""The tensor-core body of the port's score kernels (K1 score_topw, K3
score_tilemax, K8 score_parity, and the score plane's K2 score_bmax, K4
score_t and K5 score_rows; kmersgwas_tpu_torch/csrc/score_wgmma.cuh,
score_plane.cu) on the CPU: its operand preparation, a torch emulation of
its arithmetic, of the score plane's epilogues (K5's store walk included)
and of the per-tile top-3 of K1, K3 and K8 (csrc/tile_top3.cuh, round by
round on ordered keys), and the wrappers' refusals. The kernels themselves run only on
the card (tests/test_torch_gpu.py).

The emulation reads the B operand the way the kernel's descriptors do
(8x8 core matrices, 128 bytes apart along the samples, 1024 along the
columns, 256 bytes per k16 step, one block per plane and 64-sample stage)
and adds, per 16-sample k step and plane, the f32 product of the 0/1 bits
and the bf16 plane to an f32 accumulator, as the tensor cores do. Dyadic
phenotypes (multiples of 1/8) keep every partial sum exact, so it must equal
the plain versions and the JAX package bit for bit; Gaussian phenotypes at
"highest" are held to RTOL of the score plus RTOL of the column's largest
score (as tests/test_torch_ops.py holds them).
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from kmersgwas_tpu.ops import bitplanes as jbits
from kmersgwas_tpu.ops import scanstep as jss
from kmersgwas_tpu.ops import score as jscore
from kmersgwas_tpu_torch.ops import _cuda, bitplanes, score

RTOL = 1e-5


def dyadic(rng, shape):
    return (np.round(rng.uniform(-8, 8, size=shape) * 8) / 8).astype(
        np.float32)


def problem(seed, rows=256, n=100, p=3, gaussian=False, pad_rows=9,
            tie_runs=False):
    """Packed planes (uint32), popcounts and (n_pad, p) phenotypes; the last
    `pad_rows` rows are padding; tie_runs duplicates rows in runs of 1-4
    so that a tile's 2nd and 3rd values tie."""
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    bits = rng.integers(0, 2, size=(rows, n)).astype(np.uint8)
    if tie_runs:
        r = 0
        while r < rows:
            run = int(rng.integers(1, 5))
            bits[r:r + run] = bits[r]
            r += run
    bits[rows - pad_rows:] = 0
    padded = np.zeros((rows, n_pad), np.uint8)
    padded[:, :n] = bits
    y = (rng.normal(size=(n, p)).astype(np.float32) if gaussian
         else dyadic(rng, (n, p)))
    yp, ysum = jscore.prepare_phenotypes(y, n_pad)
    return dict(packed=jbits.pack_bits_np(padded),
                pc=bits.sum(1).astype(np.float32), yp=np.array(yp),
                ysum=np.array(ysum), n=n, p=p)


def torch_args(pb):
    return (bitplanes.as_planes(pb["packed"]), torch.from_numpy(pb["pc"]),
            torch.from_numpy(pb["yp"]), torch.from_numpy(pb["ysum"]))


def jax_args(pb):
    return (jnp.asarray(pb["packed"]), jnp.asarray(pb["pc"]),
            jnp.asarray(pb["yp"]), jnp.asarray(pb["ysum"]))


def emulate_yigi_t(packed, popcnt, y_padded, y_sum, precision):
    """(n_cc * nc, R) sums as the kernel computes them, from the operand
    its wrapper builds (`_plane_inputs`), and the padded column sums."""
    rows, _, p, b, ys = score._plane_inputs(packed, popcnt, y_padded, y_sum,
                                            precision)
    nc, n_cc, planes = score._chunk_args(b)
    n_kc = b.shape[1]
    flat = b.reshape(n_cc, n_kc, -1).to(torch.float32)
    bits = bitplanes.unpack_bits(packed, torch.float32)       # (R, N_pad)
    # element offsets (bf16 units) of a k16 step's (nb, kb, n8, k8): LBO
    # 128 bytes, SBO 1024 bytes, 16 bytes per column of a core matrix
    nb = torch.arange(nc // 8)[:, None, None, None]
    kb = torch.arange(2)[None, :, None, None]
    n8 = torch.arange(8)[None, None, :, None]
    k8 = torch.arange(8)[None, None, None, :]
    off = kb * 64 + nb * 512 + n8 * 8 + k8
    yigi = torch.empty((n_cc * nc, rows), dtype=torch.float32)
    for cc in range(n_cc):
        acc = torch.zeros((rows, nc), dtype=torch.float32)
        for kc in range(n_kc):
            for ks in range(4):
                a = bits[:, 64 * kc + 16 * ks:64 * kc + 16 * ks + 16]
                for pl in range(planes):
                    blk = flat[cc, kc, pl * 64 * nc + ks * 128 + off]
                    acc = acc + a @ blk.permute(1, 3, 0, 2).reshape(16, nc)
        yigi[cc * nc:(cc + 1) * nc] = acc.T
    return yigi, ys


def emulate_scores_t(packed, popcnt, y_padded, y_sum, *, n_used, min_count,
                     precision):
    """(P, R) scores as the kernel computes them: the emulated sums and
    `score_epilogue` (-inf on padding rows)."""
    yigi, ys = emulate_yigi_t(packed, popcnt, y_padded, y_sum, precision)
    return score.score_epilogue_t(yigi, popcnt, ys, n_used,
                                  min_count)[:y_padded.shape[1]].contiguous()


def emulate_rows(packed, popcnt, y_padded, y_sum, *, n_used, min_count,
                 precision):
    """K5's (R, P) scores as score_plane_kernel's row-major mode computes
    them: the emulated sums and `score_value` (no padding mask), the
    tile's real columns stored row-major."""
    yigi, ys = emulate_yigi_t(packed, popcnt, y_padded, y_sum, precision)
    sc = score.score_epilogue(yigi.T, popcnt, ys, n_used, min_count)
    return sc[:, :y_padded.shape[1]].contiguous()


def rows_store_walk(nc, p, c0, threads=256, tile_rows=128):
    """The offsets from scores[row0 * P] that each consumer thread of K5's
    epilogue stores to, in its order (csrc/score_plane.cu PLANE_ROWS: the
    (row, column) it carries instead of dividing)."""
    dr, dc = threads // nc, threads % nc
    walk = []
    for t in range(threads):
        r, c, offs = t // nc, t % nc, []
        for _ in range(t, tile_rows * nc, threads):
            offs.append(r * p + c0 + c)
            r, c = r + dr, c + dc
            if c >= nc:
                r, c = r + 1, c - nc
        walk.append(offs)
    return walk


def emulate_plane(args, **kw):
    """K2's outputs as its epilogue (csrc/score_plane.cu) makes them from
    the tile: column c of a 128-row tile is copied whole to scores[c,
    row0:row0 + 128]; for the block maxima lane l of the column's warp
    takes the max of rows 4l to 4l+3, two xor shuffles (1, 2) take it over
    lanes 4g to 4g+3, and lane 4g writes bmax[c, row0 / 16 + g]. -> (scores
    (P, R), bmax (P, R/16))."""
    sc = emulate_scores_t(*args, **kw)
    p, r = sc.shape
    lane = sc.view(p, r // 128, 32, 4).amax(dim=-1)
    bmax = lane.view(p, r // 128, 8, 4).amax(dim=-1)
    return sc, bmax.reshape(p, r // 16)


def jax_plane(pb, y_cols=None, precision="default"):
    """The JAX package's score_batch_t_pallas and score_batch_t_pallas_bmax
    in interpret mode on the columns `y_cols` (default: all), with the
    strided block maxima refolded into contiguous ones from the scores.
    -> (K4 scores, K2 scores, K2 contiguous bmax), numpy."""
    packed, pc, yp, ysum = jax_args(pb)
    if y_cols is not None:
        cols = jnp.asarray(y_cols)
        yp, ysum = yp[:, cols], ysum[cols]
    kw = dict(n_used=pb["n"], min_count=2, tile_rows=128,
              precision=precision)
    with pltpu.force_tpu_interpret_mode():
        s4 = np.array(jscore.score_batch_t_pallas(packed, pc, yp, ysum,
                                                  **kw))
        s2, _ = jscore.score_batch_t_pallas_bmax(packed, pc, yp, ysum,
                                                 block=16, **kw)
    s2 = np.array(s2)
    return s4, s2, s2.reshape(s2.shape[0], -1, 16).max(axis=2)


def emulate_topw(args, thresh, *, tile_rows, cand_w, **kw):
    sc = emulate_scores_t(*args, **kw)
    v3, lanes, ok = score._tile_top3(sc, thresh, tile_rows)
    p = sc.shape[0]
    return (*score._select(v3.reshape(p, -1), lanes.reshape(p, -1), cand_w),
            ok)


def assert_close(got, want, scale):
    fin = torch.isfinite(want)
    assert torch.equal(torch.isfinite(got), fin)
    d = torch.where(fin, (got - want).abs(), 0.0)
    assert bool((d <= RTOL * (torch.where(fin, want.abs(), 0.0)
                              + scale)).all()), float(d.max())


# ------------------------------------------------------ operand preparation

def test_default_plane_is_bf16_of_y():
    y = torch.from_numpy(np.random.default_rng(1).normal(
        size=(256, 7)).astype(np.float32))
    planes = score.bf16_planes(y, "default")
    assert planes.shape == (1, 256, 7)
    assert torch.equal(planes[0], y.to(torch.bfloat16).to(torch.float32))
    with pytest.raises(ValueError, match="precision"):
        score.bf16_planes(y, "tf32")


@pytest.mark.parametrize("scale", [1.0, 1e30, 1e-30])
def test_highest_planes_sum_to_y_exactly(scale):
    """hi + mid + lo == y exactly (summed in f64, where no addition can
    round) wherever lo's bits are normal, |y| >= 2^-110 (lo carries y's
    bits 17-24, 2^-16 below y, and bf16's normal range ends at 2^-126, as
    f32's does); below that lo is a bf16 subnormal, spaced 2^-133, and the
    sum is within that spacing of y. Every plane is exact in bf16 and each
    is at most half an ulp of the one before; summed in f32 as the tensor
    core's adder does, the three give y back within one ulp of y (the two
    f32 additions can round once where hi + mid needs a 25th bit)."""
    rng = np.random.default_rng(2)
    y = (rng.normal(size=(512, 9)) * scale).astype(np.float32)
    y[0, :3] = [0.0, 1.0, -3.0]                       # exact in bf16
    yt = torch.from_numpy(y)
    hi, mid, lo = score.bf16_planes(yt, "highest")
    for plane in (hi, mid, lo):
        assert torch.equal(plane, plane.to(torch.bfloat16).to(torch.float32))
    s64 = hi.double().numpy() + mid.double().numpy() + lo.double().numpy()
    normal = np.abs(y) >= 2.0 ** -110
    np.testing.assert_array_equal(s64[normal], y[normal].astype(np.float64))
    assert (np.abs(s64 - y) <= 2.0 ** -133).all()
    assert normal.mean() > 0.99
    assert (mid.abs() <= hi.abs() * 2.0 ** -8).all()
    assert (lo.abs() <= mid.abs() * 2.0 ** -8).all()
    assert torch.equal(mid[0, :3], torch.zeros(3))
    s32 = ((hi + mid) + lo).numpy()
    ulp = np.spacing(np.abs(y))
    assert (np.abs(s32.astype(np.float64) - y) <= ulp).all()


@pytest.mark.parametrize("p,nc,n_cc", [(1, 8, 1), (8, 8, 1), (101, 104, 1),
                                       (104, 104, 1), (256, 128, 2),
                                       (257, 104, 3), (1013, 128, 8)])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_wgmma_operand_layout(p, nc, n_cc, precision):
    """The chunk choice, and the operand decoded from its layout: each
    element is its plane's y, padding columns (past P) and padding samples
    (past N, zero in y_padded) are 0."""
    assert score.column_chunks(p) == (nc, n_cc)
    assert nc in _cuda.WGMMA_CHUNKS and n_cc * nc >= p and nc <= 128
    rng = np.random.default_rng(p)
    n, n_pad = 100, 128
    yp, _ = score.prepare_phenotypes(rng.normal(size=(n, p)), n_pad, "cpu")
    b = score.wgmma_operand(yp, precision, nc)
    planes = score.bf16_planes(yp, precision)
    n_pl = planes.shape[0]
    assert b.dtype == torch.bfloat16 and b.is_contiguous()
    assert b.shape == (n_cc, n_pad // 64, n_pl, nc // 8, 8, 8, 8)
    # (chunk, stage, plane, nb, kb, n8, k8) -> (plane, sample, column)
    dec = b.float().permute(2, 1, 4, 6, 0, 3, 5).reshape(n_pl, n_pad,
                                                         n_cc * nc)
    assert torch.equal(dec[:, :, :p], planes)
    assert not dec[:, :, p:].any() and not dec[:, n:, :].any()


# ------------------------------------------------ the kernel's arithmetic

@pytest.mark.parametrize("p", [1, 3, 8, 101, 257])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_emulated_topw_equals_plain_and_jax(p, precision):
    pb = problem(10 + p, p=p)
    args = torch_args(pb)
    kw = dict(n_used=pb["n"], min_count=2, precision=precision)
    want_sc = score.scores_t_plain(*args, **kw)
    q = torch.quantile(want_sc[:, :-9], 0.95, dim=1).contiguous()
    for th in (torch.full((p,), float("-inf")), q):
        got = emulate_topw(args, th, tile_rows=128, cand_w=64, **kw)
        want = score.topw_plain(*args, th, tile_rows=128, cand_w=64, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        v_x, _, _ = jss._topw_xla(*jax_args(pb), jnp.asarray(th.numpy()),
                                  pb["n"], 2, 128, 64, precision=precision)
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(v_x))


@pytest.mark.parametrize("p", [3, 101])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_emulated_tilemax_equals_plain_and_jax(p, precision):
    """K3's nine planes from the emulated scores, on rows with runs of
    equal rows: bit-equal to tilemax_plain, and to the JAX package's XLA
    mirror where its sum-encoded lanes are meaningful."""
    pb = problem(20 + p, p=p, tie_runs=True)
    args = torch_args(pb)
    kw = dict(n_used=pb["n"], min_count=2, precision=precision)
    sc = emulate_scores_t(*args, **kw)
    th = torch.quantile(sc[:, :-9], 0.9, dim=1).contiguous()
    got = score.tilemax_from_scores(sc, th, 64)
    want = score.tilemax_plain(*args, th, tile_rows=64, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert bool((got[6] > 1).any()) and bool((got[7] > 1).any())
    ref = [np.asarray(x) for x in jss._tilemax(
        *jax_args(pb), jnp.asarray(th.numpy()), pb["n"], 2, "xla", 64,
        precision=precision)]
    for i in (0, 1, 2, 6, 8):                 # tmax, targ, tmax2, n2, cnt
        np.testing.assert_array_equal(got[i].numpy(), ref[i])
    one2 = ref[6] == 1
    for i in (3, 4, 7):                       # targ2, tmax3, n3
        np.testing.assert_array_equal(got[i].numpy()[one2], ref[i][one2])


def test_emulated_parity_lists_equal_plain():
    """K8 runs K1's tile launch: its lists from the emulated scores equal
    parity_plain's."""
    pb = problem(31, rows=1024, p=5)
    args = torch_args(pb)
    kw = dict(n_used=pb["n"], min_count=2, precision="default")
    sc = emulate_scores_t(*args, **kw)
    th = torch.quantile(sc[:, :-9], 0.99, dim=1).contiguous()
    v3, lanes, ok = score._tile_top3(sc, th, 256)
    va, ga = score._select(v3[:, 0::2].reshape(5, -1),
                           lanes[:, 0::2].reshape(5, -1), 16)
    vb, gb = score._select(v3[:, 1::2].reshape(5, -1),
                           lanes[:, 1::2].reshape(5, -1), 16)
    want = score.parity_plain(*args, th, tile_rows=256, w=16, **kw)
    for a, b in zip((va, ga, vb, gb, ok), want):
        assert torch.equal(a, b)


def score_keys(sc):
    """The kernels' order-preserving 32-bit key of each score
    (csrc/tile_top3.cuh score_key), as int64: key(a) > key(b) iff a > b."""
    u = sc.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, 0xFFFFFFFF - u, u | 1 << 31)


def key_scores(k):
    """csrc/tile_top3.cuh key_score: the score whose key is k."""
    u = torch.where(k >= 1 << 31, k & 0x7FFFFFFF, 0xFFFFFFFF - k)
    return torch.where(u >= 1 << 31, u - (1 << 32), u).to(
        torch.int32).view(torch.float32)


def emulate_tile_top3(sc):
    """csrc/tile_top3.cuh column_top3 on every (column, 128-row tile) of
    (P, R) scores, on the kernel's layout: lane tr holds rows tr + 32*i
    (i < 4). Three rounds: each lane's best untaken key (a strict > walk
    over i, so the lowest i wins ties), the warp max m of those, the warp
    min of the rows of the lanes whose best is m, and the lane holding that
    row sets its key to 0. -> (values (P, T, 3), batch lanes (P, T, 3)
    int32)."""
    p, r = sc.shape
    t = r // 128
    k = score_keys(sc).view(p, t, 4, 32)                  # [c, tile, i, tr]
    tr = torch.arange(32)
    vals, rows = [], []
    for rnd in range(3):
        best, best_row = k[:, :, 0], tr.expand(p, t, 32)
        for i in range(1, 4):
            take = k[:, :, i] > best
            best = torch.where(take, k[:, :, i], best)
            best_row = torch.where(take, tr + 32 * i, best_row)
        m = best.amax(dim=-1, keepdim=True)                # __reduce_max_sync
        row = torch.where(best == m, best_row, 0xFFFFFFFF).amin(
            dim=-1, keepdim=True)                          # __reduce_min_sync
        if rnd < 2:
            d = row - tr                                   # (p, t, 32)
            k = torch.where(d[:, :, None, :] == 32 * torch.arange(4)[:, None],
                            0, k)
        vals.append(m)
        rows.append(row)
    v = key_scores(torch.cat(vals, dim=-1))
    g = torch.cat(rows, dim=-1) + 128 * torch.arange(t)[:, None]
    return v, g.to(torch.int32)


def top3_scores(case):
    """(P, R) scores of one tie-heavy case of the kernels' top-3."""
    rng = np.random.default_rng(60)
    if case in ("tie_runs", "padding_tile", "mac_filtered"):
        pb = problem(61, p=5, tie_runs=case == "tie_runs",
                     pad_rows=128 + 9 if case == "padding_tile" else 9)
        mc = pb["n"] if case == "mac_filtered" else 2
        return emulate_scores_t(*torch_args(pb), n_used=pb["n"],
                                min_count=mc, precision="default")
    sc = torch.from_numpy(np.abs(dyadic(rng, (4, 384))))     # scores >= 0
    if case == "one_lane":
        # column c's three best rows of tile 0 all lie in lane 5 + c, and
        # tile 1's three best, equal, in lane 7
        for c in range(4):
            sc[c, [5 + c, 37 + c, 69 + c]] = torch.tensor([9.0, 9.5, 9.25])
        sc[:, [128 + 39, 128 + 71, 128 + 103]] = 9.0
    else:
        # dyadic ties split across lanes: few distinct values, and in tile
        # 1 the best value only at rows 40, 9, 72 (lanes 8, 9, 8)
        sc = torch.from_numpy(rng.integers(0, 3, size=(4, 384)).astype(
            np.float32) / 8)
        sc[:, 128:256] = 0.0
        sc[:, [128 + 40, 128 + 9, 128 + 72]] = 1.0
    sc[:, -5:] = float("-inf")
    return sc


@pytest.mark.parametrize("case", ["tie_runs", "padding_tile", "mac_filtered",
                                  "one_lane", "dyadic_ties"])
def test_emulated_tile_top3_equals_plain(case):
    """The kernels' per-tile top-3 (K1's tile launch, K3, K8), emulated
    round by round on ordered keys, equals the plain stable top-3 bit for
    bit, lowest lane first on ties."""
    sc = top3_scores(case)
    assert not bool(sc.isnan().any())
    assert not bool(((sc == 0) & sc.signbit()).any())    # no -0.0
    v, g = emulate_tile_top3(sc)
    v3, lanes, _ = score._tile_top3(sc, torch.full((sc.shape[0],),
                                                   float("-inf")), 128)
    assert torch.equal(v.view(torch.int32), v3.view(torch.int32))
    assert torch.equal(g, lanes)
    if case == "padding_tile":
        assert bool((v[:, 1] == float("-inf")).all())
        assert torch.equal(g[:, 1], torch.tensor([128, 129, 130]).expand(
            sc.shape[0], 3).to(torch.int32))
    if case == "mac_filtered":
        assert bool((v[:, 0] == 0).all())
        assert torch.equal(g[:, 0], torch.tensor([0, 1, 2]).expand(
            sc.shape[0], 3).to(torch.int32))
    if case == "one_lane":
        assert torch.equal(g[:, 0] % 32, (5 + torch.arange(4))[:, None]
                           .expand(4, 3).to(torch.int32))
        assert torch.equal(g[:, 1], torch.tensor([167, 199, 231]).expand(
            4, 3).to(torch.int32))
    if case == "dyadic_ties":
        assert torch.equal(g[:, 1], torch.tensor([137, 168, 200]).expand(
            4, 3).to(torch.int32))


@pytest.mark.parametrize("p", [3, 101])
def test_emulated_highest_gaussian_within_rtol(p):
    """Three bf16 planes summed per k step stay within RTOL of the plain
    f32 scores and of the JAX package's on Gaussian phenotypes; "default"
    on the same inputs is off by far more (the bf16 rounding of y)."""
    pb = problem(40 + p, p=p, gaussian=True)
    args = torch_args(pb)
    kw = dict(n_used=pb["n"], min_count=2)
    got = emulate_scores_t(*args, precision="highest", **kw)
    want = score.scores_t_plain(*args, precision="highest", **kw)
    scale = torch.where(torch.isfinite(want), want.abs(), 0.0).amax(
        dim=1, keepdim=True)
    assert_close(got, want, scale)
    jx = torch.from_numpy(np.array(jss._scores_t_xla(
        *jax_args(pb), pb["n"], 2)))
    assert_close(got, jx, scale)
    dflt = emulate_scores_t(*args, precision="default", **kw)
    fin = torch.isfinite(want)
    assert float((dflt - want)[fin].abs().max()) > \
        100 * float((got - want)[fin].abs().max())


@pytest.mark.parametrize("p", [1, 3, 8, 101, 257])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_emulated_plane_equals_plain_and_jax(p, precision):
    """K2's scores and contiguous block maxima and K4's scores, emulated
    through the tensor-core arithmetic and the score plane's epilogue, on
    dyadic phenotypes with padding rows: bit-equal to the plain versions
    and to the JAX package's kernels in interpret mode (whose strided block
    maxima are refolded from its scores)."""
    pb = problem(50 + p, p=p)
    args = torch_args(pb)
    kw = dict(n_used=pb["n"], min_count=2, precision=precision)
    sc, bmax = emulate_plane(args, **kw)
    assert sc.shape == (p, 256) and bmax.shape == (p, 16)
    assert bool((sc[:, -9:] == float("-inf")).all())
    ps, pbm = score.scores_and_bmax_plain(*args, **kw)
    assert torch.equal(sc, ps) and torch.equal(bmax, pbm)
    assert torch.equal(sc, score.scores_t_plain(*args, **kw))
    s4, s2, b2 = jax_plane(pb, precision=precision)
    for got, want in ((sc, s4), (sc, s2), (bmax, b2)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("gaussian,precision", [
    (False, "default"), (False, "highest"), (True, "highest")])
def test_emulated_plane_on_a_column_subset(gaussian, precision):
    """The fallback calls K2 on the failing column groups only,
    y_padded[:, cols]: the emulation on cols = [0, 5, 6, 99] of 101 columns
    (one chunk of 8) against the plain versions and the JAX kernels on the
    same columns, bit-equal on dyadic phenotypes, within RTOL on Gaussian
    ones at "highest"."""
    pb = problem(60, p=101, gaussian=gaussian)
    cols = [0, 5, 6, 99]
    packed, pc, yp, ysum = torch_args(pb)
    sub = (packed, pc, yp[:, cols], ysum[cols])
    kw = dict(n_used=pb["n"], min_count=2, precision=precision)
    assert score.column_chunks(len(cols)) == (8, 1)
    sc, bmax = emulate_plane(sub, **kw)
    ps, pbm = score.scores_and_bmax_plain(*sub, **kw)
    full = score.scores_t_plain(packed, pc, yp, ysum, **kw)[cols]
    s4, s2, b2 = jax_plane(pb, cols, precision)
    if not gaussian:
        assert torch.equal(sc, ps) and torch.equal(bmax, pbm)
        assert torch.equal(sc, full)
        for got, want in ((sc, s4), (sc, s2), (bmax, b2)):
            np.testing.assert_array_equal(got.numpy(), want)
        return
    scale = torch.where(torch.isfinite(ps), ps.abs(), 0.0).amax(
        dim=1, keepdim=True)
    for got, want in ((sc, ps), (sc, torch.from_numpy(s4)),
                      (sc, torch.from_numpy(s2)), (bmax, pbm),
                      (bmax, torch.from_numpy(b2))):
        assert_close(got, want, scale)


def jax_rows(pb):
    """The JAX package's score_batch and its Pallas score_batch_pallas in
    interpret mode (both f32 sums of the f32 y), numpy."""
    args = jax_args(pb)
    kw = dict(n_used=pb["n"], min_count=2)
    xla = np.array(jscore.score_batch(*args, **kw))
    with pltpu.force_tpu_interpret_mode():
        pallas = np.array(jscore.score_batch_pallas(*args, tile_rows=128,
                                                    **kw))
    return xla, pallas


@pytest.mark.parametrize("p", [1, 3, 8, 101, 257])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_emulated_rows_equal_plain_and_jax(p, precision):
    """K5 (score_plane_kernel's row-major mode), emulated through the
    tensor-core arithmetic and `score_value`, on dyadic phenotypes with
    padding rows: the padding rows score 0, and the scores equal the plain
    version, the JAX package's score_batch and its Pallas kernel in
    interpret mode bit for bit, and K4's emulated scores transposed with
    -inf as 0 (the identity the card checks on the flagship)."""
    pb = problem(70 + p, p=p)
    args = torch_args(pb)
    kw = dict(n_used=pb["n"], min_count=2, precision=precision)
    sc = emulate_rows(*args, **kw)
    assert sc.shape == (256, p) and not sc[-9:].any()
    assert bool(torch.isfinite(sc).all())
    assert torch.equal(sc, score.scores_plain(*args, **kw))
    k4 = emulate_scores_t(*args, **kw)
    assert torch.equal(sc, torch.where(k4 == float("-inf"), 0.0, k4).T)
    for want in jax_rows(pb):
        np.testing.assert_array_equal(sc.numpy(), want)


@pytest.mark.parametrize("p", [3, 101])
def test_emulated_rows_highest_gaussian_within_rtol(p):
    """K5's emulated scores on Gaussian phenotypes at "highest": within
    RTOL of the plain f32 scores and of the JAX package's (both kernels),
    column by column, and equal to K4's emulated scores transposed with
    -inf as 0 bit for bit (one arithmetic)."""
    pb = problem(80 + p, p=p, gaussian=True)
    args = torch_args(pb)
    kw = dict(n_used=pb["n"], min_count=2, precision="highest")
    sc = emulate_rows(*args, **kw)
    k4 = emulate_scores_t(*args, **kw)
    assert torch.equal(sc, torch.where(k4 == float("-inf"), 0.0, k4).T)
    want = score.scores_plain(*args, **kw)
    scale = want.abs().amax(dim=0, keepdim=True).T
    for ref in (want, *map(torch.from_numpy, jax_rows(pb))):
        assert_close(sc.T, ref.T, scale)


@pytest.mark.parametrize("p", [1, 3, 101, 104, 128, 129, 257, 1013])
def test_rows_store_walks_the_region_once(p):
    """K5's epilogue stores each chunk's region (rows row0 + [0, 128), its
    real columns) once: step k of consumer thread t stores element t + 256 k
    of the region in row-major order, so a warp's 32 stores are 32
    consecutive elements; where one chunk holds every column the region is
    one contiguous run of 128 * P floats."""
    nc_w, n_cc = score.column_chunks(p)
    for cc in range(n_cc):
        c0 = cc * nc_w
        nc = min(nc_w, p - c0)
        walk = rows_store_walk(nc, p, c0)
        for t, offs in enumerate(walk):
            assert offs == [(i // nc) * p + c0 + i % nc
                            for i in range(t, 128 * nc, 256)]
        every = sorted(o for offs in walk for o in offs)
        assert every == sorted(r * p + c0 + c for r in range(128)
                               for c in range(nc))
        if n_cc == 1:
            assert every == list(range(128 * p))


# ------------------------------------------------------------ refusals

def good_inputs(rows=256, n_pad=128, p=3):
    pb = problem(5, rows=rows, n=min(100, n_pad), p=p)
    return list(torch_args(pb)) + [torch.zeros(p)]


@pytest.mark.parametrize("case,match", [
    ("rows", "multiple of 128"),
    ("w32_odd", "multiple of 4"),
    ("w32_big", "multiple of 4"),
    ("n_pad", "32\\*W32"),
    ("no_columns", "at least one column"),
    ("thresh", "thresh must be"),
    ("ysum_shape", "y_sum must be"),
    ("dtype", "float32"),
    ("packed", "contiguous \\(R, W32\\) int32"),
])
def test_wgmma_inputs_refuse_bad_shapes(case, match):
    packed, pc, yp, ysum, th = bad_inputs(case)
    with pytest.raises(ValueError, match=match):
        score._wgmma_inputs(packed, pc, yp, ysum, th, "default")


@pytest.mark.parametrize("case,match", [
    ("rows", "multiple of 128"),
    ("w32_odd", "multiple of 4"),
    ("w32_big", "multiple of 4"),
    ("n_pad", "32\\*W32"),
    ("no_columns", "at least one column"),
    ("ysum_shape", "y_sum must be"),
    ("dtype", "float32"),
    ("packed", "contiguous \\(R, W32\\) int32"),
    ("precision", "precision"),
])
def test_plane_inputs_refuse_bad_shapes(case, match):
    """What K2 and K4 take on the card (`_plane_inputs`): the batch checks
    of the thresholded kernels, without a threshold."""
    packed, pc, yp, ysum, _ = bad_inputs(case)
    with pytest.raises(ValueError, match=match):
        score._plane_inputs(packed, pc, yp, ysum,
                            "tf32" if case == "precision" else "default")


def bad_inputs(case):
    packed, pc, yp, ysum, th = good_inputs()
    if case == "rows":
        packed, pc = packed[:200].contiguous(), pc[:200].contiguous()
    elif case == "w32_odd":                   # N_pad 64: W32 = 2
        packed, yp = packed[:, :2].contiguous(), yp[:64]
    elif case == "w32_big":                   # W32 = 388 > 384
        packed = torch.zeros((128, 388), dtype=torch.int32)
        pc = torch.ones(128)
        yp = torch.zeros((388 * 32, 3))
    elif case == "n_pad":
        yp = torch.zeros((256, 3))
    elif case == "no_columns":
        yp, ysum, th = yp[:, :0], ysum[:0], th[:0]
    elif case == "thresh":
        th = th.double()
    elif case == "ysum_shape":
        ysum = ysum[:2]
    elif case == "dtype":
        pc = pc.double()
    elif case == "packed":
        packed = packed.t()
    return packed, pc, yp, ysum, th


def test_wgmma_inputs_pad_the_chunk():
    packed, pc, yp, ysum, th = good_inputs(p=101)
    rows, w32, p, b, ys, tp = score._wgmma_inputs(packed, pc, yp, ysum,
                                                  th + 1.0, "highest")
    assert (rows, w32, p) == (256, 4, 101)
    assert score._chunk_args(b) == (104, 1, 3)
    assert torch.equal(ys[:101], ysum) and not ys[101:].any()
    assert torch.equal(tp[:101], th + 1.0)
    assert bool((tp[101:] == float("inf")).all())
    plane = score._plane_inputs(packed, pc, yp, ysum, "highest")
    assert plane[:3] == (256, 4, 101) and torch.equal(plane[3], b)
    assert torch.equal(plane[4], ys)


def test_tensor_core_wrappers_have_no_cpu_kernel_path():
    """CPU tensors take the plain versions; tensors on any other non-CUDA
    device are refused: there is no route around the kernel."""
    pb = problem(6, p=3)
    args = torch_args(pb)
    th = torch.full((3,), 5.0)
    kw = dict(n_used=pb["n"], min_count=2)
    planes = score.score_batch_t_tilemax(*args, th, tile_rows=64, **kw)
    for a, b in zip(planes, score.tilemax_plain(*args, th, tile_rows=64,
                                                **kw)):
        assert torch.equal(a, b)
    got = score.score_batch_t_parity(*args, th, tile_rows=128, w=8, **kw)
    for a, b in zip(got, score.parity_plain(*args, th, tile_rows=128, w=8,
                                            **kw)):
        assert torch.equal(a, b)
    for a, b in zip(score.score_batch_t_bmax(*args, **kw),
                    score.scores_and_bmax_plain(*args, **kw)):
        assert torch.equal(a, b)
    assert torch.equal(score.score_batch_t(*args, **kw),
                       score.scores_t_plain(*args, **kw))
    assert torch.equal(score.score_batch(*args, **kw),
                       score.scores_plain(*args, **kw))
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="no kernel"):
        score.score_batch_t_tilemax(*meta, th.to("meta"), tile_rows=128, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        score.score_batch_t_parity(*meta, th.to("meta"), tile_rows=128, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        score.score_batch_t_bmax(*meta, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        score.score_batch_t(*meta, **kw)
    with pytest.raises(ValueError, match="no kernel"):
        score.score_batch(*meta, **kw)

