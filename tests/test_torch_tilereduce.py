"""K9, the tile-reduction probes: the port's plain planes
(kmersgwas_tpu_torch.ops.tilereduce, through the cases of
kmersgwas_tpu_torch.tools.exp_kernel) against the Pallas kernels of
tools/exp_kernel.py run in interpret mode on the CPU.

tools/exp_kernel.py is a script, not a module of the JAX package, so it is
loaded by file path. Its kernels are fixed to P_PAD = 104 rows and NT = 128
tiles (their stores and broadcasts name both); the tile width TR is the
block's and is cut to 16 and 256 lanes. The input is the probe's
tie-heavy plane (round(normal * 2), seeded, -0.0 made +0.0), so the tie
rules are what is tested: the halving fold's index, the first argmax, the
sum-encoded 2nd lane and k_topc's order of equal maxima. Every comparison
is exact (values bit for bit, indices and counts equal)."""
import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from kmersgwas_tpu_torch.ops import tilereduce as tred
from kmersgwas_tpu_torch.tools import exp_kernel as ek

ROOT = pathlib.Path(__file__).resolve().parents[1]


def _load_probe():
    spec = importlib.util.spec_from_file_location(
        "jax_exp_kernel_probe", ROOT / "tools" / "exp_kernel.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)        # defines kernels; runs no case
    return mod


PROBE = _load_probe()
P_PAD, NT = PROBE.P_PAD, PROBE.NT


def jax_outputs(case, x):
    """The case's JAX kernel(s) on x (P_PAD, NT*TR) in interpret mode ->
    their outputs as numpy arrays, in the case's order."""
    tr = x.shape[1] // NT
    kernels = [getattr(PROBE, name) for name in case.jax]
    per = len(case.outs) // len(kernels)
    out = []
    for i, kernel in enumerate(kernels):
        names = case.outs[i * per:(i + 1) * per]
        dtypes = [jnp.float32 if n in ("m1", "m2", "topc_v") else jnp.int32
                  for n in names]
        in_specs = [pl.BlockSpec((P_PAD, tr), lambda t: (0, t),
                                 memory_space=pltpu.VMEM)]
        args = [jnp.asarray(x)]
        if kernel is PROBE.k_cnt:
            in_specs.append(pl.BlockSpec((P_PAD, 1), lambda t: (0, 0),
                                         memory_space=pltpu.VMEM))
            args.append(jnp.full((P_PAD, 1), case.th, jnp.float32))
        with pltpu.force_tpu_interpret_mode():
            res = pl.pallas_call(
                kernel, grid=(NT,), in_specs=in_specs,
                out_specs=[pl.BlockSpec((P_PAD, NT), lambda t: (0, 0),
                                        memory_space=pltpu.VMEM)] * len(names),
                out_shape=[jax.ShapeDtypeStruct((P_PAD, NT), d)
                           for d in dtypes])(*args)
        out += [np.asarray(r) for r in res]
    return out


@pytest.mark.parametrize("tr", [16, 256])
@pytest.mark.parametrize("name", list(ek.CASES))
def test_case_plain_equals_jax_kernel(name, tr):
    case = ek.CASES[name]
    x = ek.tie_heavy(P_PAD, NT, tr, seed=tr)
    want = jax_outputs(case, x)
    got = [g.numpy() for g in ek.case_planes(case, torch.from_numpy(x), NT)]
    assert len(got) == len(want)
    for plane, g, w in zip(case.outs, got, want):
        assert g.dtype == w.dtype, plane
        np.testing.assert_array_equal(g, w, err_msg=f"{name} {plane}")
    # the tool's numpy function of the kernel agrees as well
    for g, w in zip(got, case.numpy(x.reshape(P_PAD, NT, tr))):
        np.testing.assert_array_equal(g, w)
    if name in ("vi", "vif") and tr == 256:
        # the halving fold is not the first argmax on ties
        first = x.reshape(P_PAD, NT, tr).argmax(axis=2)
        assert (got[1] != first).any()


def test_tile_topc_is_a_stable_descending_sort():
    m1 = torch.from_numpy(np.round(np.random.default_rng(3).normal(
        size=(7, 40)) * 2).astype(np.float32) + np.float32(0))
    m1[0, 5] = float("-inf")                   # a -inf maximum is dropped
    v, i = tred.tile_topc(m1)
    order = torch.sort(m1, dim=1, descending=True, stable=True)
    fin = torch.isfinite(order.values)
    assert torch.equal(v, torch.where(fin, order.values, v))
    assert torch.equal(i[fin], order.indices[fin].to(torch.int32))
    assert float(v[0, -1]) == float("-inf") and int(i[0, -1]) == 0


def topc_rank(m):
    """tile_topc's kernel as a rank rule: a maximum that is not -inf lands
    in slot #{s : m_s > m_t} + #{s < t : m_s == m_t}; the slots past the
    count of such maxima hold (-inf, 0)."""
    p, nt = m.shape
    mt, ms = m[:, :, None], m[:, None, :]
    earlier = np.arange(nt)[None, :] < np.arange(nt)[:, None]    # s < t
    rank = (ms > mt).sum(-1) + ((ms == mt) & earlier).sum(-1)
    v = np.full((p, nt), -np.inf, np.float32)
    i = np.zeros((p, nt), np.int32)
    c, t = np.nonzero(m != -np.inf)
    v[c, rank[c, t]] = m[c, t]
    i[c, rank[c, t]] = t
    return v, i


def topc_plane(kind):
    """A (P_PAD, NT * 16) plane whose tile maxima are tie-heavy, carry
    -inf tiles (also the first tile and a whole column), or are all
    equal."""
    x = ek.tie_heavy(P_PAD, NT, 16, seed=11)
    v = x.reshape(P_PAD, NT, 16)
    if kind == "neg_inf":
        rng = np.random.default_rng(5)
        v[rng.random((P_PAD, NT)) < 0.3] = -np.inf
        v[:, 0] = -np.inf
        v[7] = -np.inf
    elif kind == "all_equal":
        v[:] = np.float32(2)
    return x


@pytest.mark.parametrize("kind", ["ties", "neg_inf", "all_equal"])
def test_tile_topc_rank_rule_equals_plain_and_jax(kind):
    """The parallel stable rank that the tile_topc kernel computes equals
    k_topc's chain of inserts: the plain version and the JAX kernel in
    interpret mode."""
    x = topc_plane(kind)
    m1 = x.reshape(P_PAD, NT, -1).max(axis=-1)
    want_v, want_i = topc_rank(m1)
    jv, ji = jax_outputs(ek.CASES["topc"], x)
    pv, pi = tred.tile_topc_plain(torch.from_numpy(m1))
    for v, i in ((jv, ji), (pv.numpy(), pi.numpy())):
        np.testing.assert_array_equal(v, want_v)
        np.testing.assert_array_equal(i, want_i)
    if kind == "neg_inf":
        assert (want_v[7] == -np.inf).all() and not want_i[7].any()


def test_tile_reduce_planes_and_refusals():
    x = torch.tensor([[3., 1., 3., 2., 5., 5., 0., 5.]])
    out = tred.tile_reduce(x, torch.tensor([2.5]), n_tiles=2)
    assert out["m1"].tolist() == [[3., 5.]]
    assert out["a1"].tolist() == [[0, 0]]
    assert out["a1_fold"].tolist() == [[0, 0]]
    # tile 1 masks lane 0: lanes 1 and 3 still hold 5, so a2_sum = 1 + 3
    assert out["m2"].tolist() == [[3., 5.]]
    assert out["a2_sum"].tolist() == [[2, 4]]
    assert out["n_eq"].tolist() == [[2, 3]]
    assert out["cnt"].tolist() == [[2, 3]]
    assert set(tred.tile_reduce(x, None, n_tiles=2, planes=("m1",))) \
        == {"m1"}
    with pytest.raises(ValueError, match="unknown planes"):
        tred.tile_reduce(x, None, n_tiles=2, planes=("m3",))
    with pytest.raises(ValueError, match="do not split"):
        tred.tile_reduce(x, None, n_tiles=3)
    with pytest.raises(ValueError, match="float32"):
        tred.tile_reduce(x.double(), None, n_tiles=2)
    with pytest.raises(ValueError, match="float32"):
        tred.tile_topc(x.double())


def test_exp_kernel_tool_on_the_cpu(capsys):
    recs = ek.main(device="cpu", tr=16, nt=8, p=5)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(ek.CASES) == len(recs) == 20
    assert all(r["equal_plain"] and r["equal_numpy"] for r in recs)
    assert all(r["device"] == "cpu" and "kernel_ms" not in r for r in recs)
    with pytest.raises(SystemExit):
        ek._cli(["nosuchcase", "--device", "cpu"])
