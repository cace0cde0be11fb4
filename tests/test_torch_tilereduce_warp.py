"""K9's tile_reduce kernel (kmersgwas_tpu_torch/csrc/tile_reduce.cu) as a
numpy emulation of its warp: one warp per (column, tile), lane l holding
the float4s l + 32 i of the tile (element e in lane (e / 4) mod 32,
register slot e / 128, component e mod 4); pass 1, each lane's max and
count above the threshold, and the warp's max by butterfly stages; pass 2,
each lane's count, lowest lane and lane sum at that max and its largest
value below it, merged by warp-wide sums and minima and a second butterfly;
pass 3, the lanes at the second value where one lane holds the max; and
the halving fold's register, shuffle and component stages with their lane
indices.

The emulation is held bit for bit against tile_reduce_plain (ties,
all-equal tiles, signed zeros, a single maximum, -inf) at TR 4, 128, 2048
and 4096 with fold_to in {1, 2, 128, >= TR}, and against the Pallas kernels
of tools/exp_kernel.py in interpret mode at P_PAD 104, NT 128, TR 16 and
256 on the probe's tie-heavy plane. Float planes compare by value (signed
zeros compare equal, as the module says) and, on planes without signed
zeros, by their bits; index and count planes exactly."""
import numpy as np
import pytest
import torch

from kmersgwas_tpu_torch.ops import tilereduce as tred
from kmersgwas_tpu_torch.tools import exp_kernel as ek
from test_torch_tilereduce import NT, P_PAD, jax_outputs

INT_MAX = np.int32(2**31 - 1)
NEG_INF = np.float32(-np.inf)
LANES = np.arange(32)


def lane_layout(xt):
    """(T, TR) tiles -> ((T, NV, 32, 4) values, (NV, 32, 4) element lanes,
    (32,) active): lane l's float4 i is elements 128 i + 4 l .. + 3; for TR
    < 128 only lanes l < TR / 4 hold elements, the others -inf."""
    t, tr = xt.shape
    nv = max(1, tr // 128)
    v = np.full((t, nv, 32, 4), NEG_INF, np.float32)
    active = 4 * LANES < tr
    v[:, :, :min(32, tr // 4), :] = xt.reshape(t, nv, -1, 4)
    e = (128 * np.arange(nv)[:, None, None] + 4 * LANES[None, :, None]
         + np.arange(4)[None, None, :])
    return v, e, active


def warp_max(v):
    """5 butterfly stages of __shfl_xor_sync and fmaxf: every lane ends
    with the warp's max."""
    for off in (16, 8, 4, 2, 1):
        v = np.maximum(v, v[:, LANES ^ off])
    return v


def shfl_down(v, d):
    """__shfl_down_sync(v, d) over axis 1: lane l reads lane l + d, a lane
    past the warp reads its own value."""
    src = np.where(LANES + d < 32, LANES + d, LANES)
    return v[:, src]


def keep_left(lv, li, rv, ri):
    keep = lv >= rv
    return np.where(keep, lv, rv), np.where(keep, li, ri)


def emulate(x, th, n_tiles, fold_to=1):
    """The kernel's planes (all seven) for x (P, NT*TR) f32 and th (P,) f32,
    computed as its warp does. -> {plane: (P, NT) array}."""
    p = x.shape[0]
    tr = x.shape[1] // n_tiles
    t = p * n_tiles
    v, e, active = lane_layout(x.reshape(t, tr))
    thr = np.repeat(th, n_tiles).astype(np.float32)
    nv = v.shape[1]
    nh = nv // 2 if nv > 16 else nv
    # pass 1: each lane's max and count above th (idle lanes hold -inf)
    mx = v.max(axis=(1, 3))
    c_above = np.where(active, (v > thr[:, None, None, None]).sum(
        axis=(1, 3)), 0)
    held = v[:, :nh].copy()
    ix = np.broadcast_to(e[:nh], held.shape).copy()
    width = tr
    if nv > nh and width > fold_to:
        # the second half folds into slot i as it arrives
        held, ix = keep_left(held, ix, v[:, nh:], e[nh:])
        width //= 2
    top = warp_max(mx)

    # pass 2 (the registers, or the tile read again at NV = 32): at the
    # top, each lane's count, lowest lane and lane sum; below it, its
    # largest value
    eq = (v == top[:, None, :, None]) & active[None, None, :, None]
    n_top = eq.sum(axis=(1, 2, 3))
    a_top = np.where(eq, e, INT_MAX).min(axis=(1, 2, 3))
    s_top = np.where(eq, e, 0).sum(axis=(1, 2, 3))
    below = np.where(eq | ~active[None, None, :, None], NEG_INF, v).max(
        axis=(1, 3))
    second = warp_max(below)
    top, second = top[:, 0], second[:, 0]
    m2 = np.where(n_top >= 2, top, second)
    # pass 3, for tiles with one lane at the top: the lanes at the second
    at2 = (v == second[:, None, None, None]) & active[None, None, :, None]
    s_second = np.where(at2, e, 0).sum(axis=(1, 2, 3))
    a2 = (np.where(n_top >= 2, s_top - a_top, s_second)
          + np.where(m2 == NEG_INF, a_top, 0))
    cnt = c_above.sum(axis=1)

    # the fold: register slots, then lanes, then components
    h = nh // 2
    while h >= 1:
        if width > fold_to:
            held[:, :h], ix[:, :h] = keep_left(held[:, :h], ix[:, :h],
                                               held[:, h:2 * h],
                                               ix[:, h:2 * h])
            width //= 2
        h //= 2
    for d in (16, 8, 4, 2, 1):
        if width == 8 * d and width > fold_to:
            held[:, 0], ix[:, 0] = keep_left(held[:, 0], ix[:, 0],
                                             shfl_down(held[:, 0], d),
                                             shfl_down(ix[:, 0], d))
            width //= 2
    for half in (2, 1):
        if width == 2 * half and width > fold_to:
            lo, hi = slice(0, half), slice(half, 2 * half)
            held[:, 0, :, lo], ix[:, 0, :, lo] = keep_left(
                held[:, 0, :, lo], ix[:, 0, :, lo], held[:, 0, :, hi],
                ix[:, 0, :, hi])
            width = half
    if width >= tr:
        fold = a_top
    else:
        pos = e[:nh]
        live = (pos < width)[None] & (held == top[:, None, None, None])
        fold = np.where(live, ix, INT_MAX).reshape(t, -1).min(axis=1)

    out = dict(m1=top, a1=a_top, a1_fold=fold, m2=m2, a2_sum=a2,
               n_eq=n_top, cnt=cnt)
    return {k: out[k].astype(np.float32 if k in ("m1", "m2") else np.int32)
            .reshape(p, n_tiles) for k in tred.PLANES}


def plane(kind, p, nt, tr, seed=0):
    """(p, nt*tr) f32 test planes: the probe's tie-heavy plane; all-equal
    tiles; signed zeros (tiles of -|round(normal)|, both zeros kept, some
    tiles all zeros); a single maximum and distinct values; -inf lanes and
    a tile of -inf only."""
    rng = np.random.default_rng(seed)
    if kind == "ties":
        return ek.tie_heavy(p, nt, tr, seed)
    if kind == "all_equal":
        x = np.repeat(rng.integers(-3, 4, size=(p, nt, 1)), tr, axis=2)
        return x.astype(np.float32).reshape(p, nt * tr)
    if kind == "signed_zero":
        x = -np.abs(np.round(rng.normal(size=(p, nt, tr)))).astype(np.float32)
        x[rng.random((p, nt, tr)) < 0.3] = np.float32(-0.0)
        x[0, 0] = np.where(np.arange(tr) % 2, np.float32(-0.0),
                           np.float32(0.0))
        return x.reshape(p, nt * tr)
    if kind == "single_max":
        x = np.stack([rng.permutation(tr) for _ in range(p * nt)])
        return x.astype(np.float32).reshape(p, nt * tr)
    if kind == "neg_inf":
        x = ek.tie_heavy(p, nt, tr, seed).reshape(p, nt, tr)
        x[rng.random((p, nt, tr)) < 0.4] = NEG_INF
        x[0, 0] = NEG_INF
        x[0, 1] = NEG_INF
        x[0, 1, 3] = 5.0                # the one finite lane is not lane 0
        return x.reshape(p, nt * tr)
    raise ValueError(kind)


def assert_planes_equal(got, want, bits):
    for k in tred.PLANES:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)
        if bits:
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                          err_msg=f"{k} bits")


def plain_planes(x, th, nt, fold_to):
    out = tred.tile_reduce_plain(torch.from_numpy(x), torch.from_numpy(th),
                                 n_tiles=nt, fold_to=fold_to)
    return {k: v.numpy() for k, v in out.items()}


@pytest.mark.parametrize("kind", ["ties", "all_equal", "signed_zero",
                                  "single_max"])
@pytest.mark.parametrize("fold_to", [1, 2, 128, "tr"])
@pytest.mark.parametrize("tr", [4, 128, 2048, 4096])
def test_emulation_equals_plain(tr, fold_to, kind):
    fold_to = tr if fold_to == "tr" else fold_to
    p, nt = 3, 5
    x = plane(kind, p, nt, tr, seed=tr + fold_to)
    th = np.array([0.5, -1.0, 0.0], np.float32)
    assert_planes_equal(emulate(x, th, nt, fold_to),
                        plain_planes(x, th, nt, fold_to),
                        bits=kind != "signed_zero")


@pytest.mark.parametrize("tr,fold_to", [(16, 1), (256, 4), (4096, 2)])
def test_emulation_equals_plain_with_neg_inf(tr, fold_to):
    """-inf lanes and a tile of -inf only: the partials count -inf as a
    value, and a2_sum adds lane a1 back where m2 is -inf."""
    x = plane("neg_inf", 2, 3, tr, seed=tr)
    th = np.zeros(2, np.float32)
    want = plain_planes(x, th, 3, fold_to)
    assert want["m1"][0, 0] == NEG_INF and want["m2"][0, 1] == NEG_INF
    assert want["a1"][0, 1] == 3
    assert_planes_equal(emulate(x, th, 3, fold_to), want, bits=True)


@pytest.mark.parametrize("fold_to", [1, 3, 100, 1024, 5000])
def test_fold_to_between_powers_of_two(fold_to):
    """fold_to need not be a power of two: the fold halves while the
    width exceeds it, as k_vi_fold's loop."""
    x = plane("ties", 2, 4, 2048, seed=fold_to)
    th = np.zeros(2, np.float32)
    assert_planes_equal(emulate(x, th, 4, fold_to),
                        plain_planes(x, th, 4, fold_to), bits=True)


def test_layout_puts_element_e_in_its_lane_slot_and_component():
    tr = 2048
    xt = np.arange(2 * tr, dtype=np.float32).reshape(2, tr)
    v, e, active = lane_layout(xt)
    assert active.all() and v.shape == (2, 16, 32, 4)
    for el in (0, 5, 127, 128, 1000, 2047):
        i, lane, c = el // 128, (el // 4) % 32, el % 4
        assert e[i, lane, c] == el and v[1, i, lane, c] == tr + el
    v, e, active = lane_layout(np.arange(16, dtype=np.float32)[None])
    assert active.sum() == 4 and np.isneginf(v[0, 0, 4:]).all()


@pytest.mark.parametrize("tr", [16, 256])
@pytest.mark.parametrize("name", [n for n in ek.CASES if n != "topc"])
def test_emulation_equals_jax_kernel(name, tr):
    """Each case's planes, emulated, against its JAX kernel(s) in interpret
    mode at the probe's P_PAD and NT on the tie-heavy plane."""
    case = ek.CASES[name]
    x = ek.tie_heavy(P_PAD, NT, tr, seed=tr)
    th = np.full(P_PAD, case.th if case.th is not None else 0.0, np.float32)
    got = emulate(x, th, NT, case.fold_to)
    for plane_name, w in zip(case.outs, jax_outputs(case, x)):
        g = got[plane_name]
        assert g.dtype == w.dtype, plane_name
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=f"{name} {plane_name}")
