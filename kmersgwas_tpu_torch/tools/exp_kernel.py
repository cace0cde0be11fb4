"""The tile-reduction probes of tools/exp_kernel.py on the port's kernels.

    python -m kmersgwas_tpu_torch.tools.exp_kernel [case ... | all]
        [--device cuda|cpu] [--tr TR] [--nt NT]

Each case of the JAX probe (one or two Pallas kernels reducing each
(P_PAD, TR) tile of an f32 plane into (P_PAD, NT) planes) is a table entry
here: the planes of the port's tile_reduce kernel (or tile_topc, for
`topc`) that compute the JAX kernel's outputs, and that kernel's function
written in numpy. On a tie-heavy plane (round(normal * 2), seeded, signed
zeros made +0) at the probe's shape (P_PAD 104, NT 128, TR 2048) each case
holds the kernel's planes bit for bit against their plain PyTorch versions
(ops/tilereduce.py) and against the numpy function, and prints one JSON
line: the case, the planes, both checks, and on the card the kernel's and
the plain version's CUDA-event times with the card's name and power limit.
`--device cpu` runs the plain versions against the numpy functions.

The JAX probe recorded how Mosaic lowered each kernel on the TPU (OK,
CRASH, HANG, N/A); those are facts of the TPU's compiler, not results of
the port, and are not printed here. Every case here computes its function:
where the JAX kernel's function differs from what its own numpy assert
expected (k_vi_fold and k_vi_f32 are not first-argmax on ties; the halving
fold favours the lane first in bit-reversed order), the port computes the
kernel's function. k_native_argmax's tie rule is unspecified on the TPU;
the port takes the first lane, as interpret mode does.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..bench import card_line
from ..ops import tilereduce as tred
from ..utils import require_device

P_PAD, TR, NT = 104, 2048, 128


# ---------------------------------------------------------------- numpy
# The JAX kernels' bodies in numpy, over every tile at once: v is
# (P, NT, TR), each function returns the kernel's outputs as (P, NT) arrays.

def np_max_fold(v):
    """k_fold_store / k_iota_only: jnp.maximum over halves."""
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = np.maximum(v[..., :h], v[..., h:2 * h])
    return v[..., 0]


def np_where_fold(v, i=None, down_to=1):
    """k_vi_fold / k_fold_where / k_vi_hybrid: keep the left half where
    left >= right (values and, given i, indices)."""
    while v.shape[-1] > down_to:
        h = v.shape[-1] // 2
        keep = v[..., :h] >= v[..., h:2 * h]
        if i is not None:
            i = np.where(keep, i[..., :h], i[..., h:2 * h])
        v = np.where(keep, v[..., :h], v[..., h:2 * h])
    return v, i


def np_min_fold(v):
    while v.shape[-1] > 1:
        h = v.shape[-1] // 2
        v = np.minimum(v[..., :h], v[..., h:2 * h])
    return v[..., 0]


def _iota(v, dtype=np.int32):
    return np.broadcast_to(np.arange(v.shape[-1], dtype=dtype), v.shape)


def np_reduce(v):
    return (v.max(axis=-1),)


def np_vi_fold(v):
    fv, fi = np_where_fold(v, _iota(v))
    return fv[..., 0], fi[..., 0]


def np_vi_f32(v):
    fv, fi = np_where_fold(v, _iota(v, np.float32))
    return fv[..., 0], fi[..., 0].astype(np.int32)


def np_cnt(th):
    return lambda v: ((v > th).sum(axis=-1).astype(np.int32),)


def np_vi_reduce(v):
    m = v.max(axis=-1, keepdims=True)
    i = np.where(v == m, _iota(v), np.int32(v.shape[-1])).min(axis=-1)
    return m[..., 0], i


def np_vi_hybrid(v):
    fv, fi = np_where_fold(v, _iota(v), down_to=128)
    m = fv.max(axis=-1, keepdims=True)
    im = np.where(fv == m, fi, np.int32(v.shape[-1])).min(axis=-1)
    return m[..., 0], im


def np_iso(v):
    """k_fold_where, then k_iota_only (v + 0 * iota, then a max fold)."""
    return (np_where_fold(v)[0][..., 0],
            np_max_fold(v + np.float32(0) * _iota(v, np.float32)))


def np_vi_twopass(v):
    tr = v.shape[-1]
    m = np_max_fold(v)[..., None]
    mi = np.where(v == m, _iota(v, np.float32), np.float32(tr))
    return m[..., 0], np_min_fold(mi).astype(np.int32)


def np_vi_arith(v):
    tr = v.shape[-1]
    m = np_max_fold(v)[..., None]
    eq = (v == m).astype(np.float32)
    mi = _iota(v, np.float32) + (np.float32(1) - eq) * np.float32(tr)
    return m[..., 0], np_min_fold(mi).astype(np.int32)


def np_fold_plus_cnt(v):
    return np_max_fold(v), (v > 0.5).sum(axis=-1).astype(np.int32)


def np_native_argmax(v):
    return v.max(axis=-1), v.argmax(axis=-1).astype(np.int32)


def _masked_second(v, a1):
    """k_top2 / k_t4: lane a1 pushed to -inf by adding -3e38 twice, then
    the max and the sum-encoded lane of its value."""
    idx = _iota(v)
    with np.errstate(over="ignore"):
        big = (idx == a1[..., None]).astype(np.float32) * np.float32(-3e38)
        v2 = v + big + big
    m2 = v2.max(axis=-1, keepdims=True)
    eq2 = (v2 == m2).astype(np.float32)
    a2 = (idx.astype(np.float32) * eq2).sum(axis=-1).astype(np.int32)
    return m2[..., 0], a2


def np_top2(v):
    m, a1 = np_native_argmax(v)
    m2, a2 = _masked_second(v, a1)
    return m, a1, m2, a2, (v > 0.5).sum(axis=-1).astype(np.int32)


def np_t1(v):
    m = v.max(axis=-1, keepdims=True)
    return ((v == m).sum(axis=-1).astype(np.int32),)


def np_t2(v):
    m1, m2 = v, np.full_like(v, -np.inf)
    while m1.shape[-1] > 1:
        h = m1.shape[-1] // 2
        a1, b1 = m1[..., :h], m1[..., h:2 * h]
        a2, b2 = m2[..., :h], m2[..., h:2 * h]
        m1 = np.maximum(a1, b1)
        m2 = np.maximum(np.minimum(a1, b1), np.maximum(a2, b2))
    return m1[..., 0], m2[..., 0]


def np_t3(v):
    s = -np.sort(-v, axis=-1)
    return s[..., 0], s[..., 1]


def np_t4(v):
    return _masked_second(v, v.argmax(axis=-1))


def np_topc(v):
    """k_topc: tile t's max inserted at rank #{carried >= it}."""
    p, nt, _ = v.shape
    m1 = v.max(axis=-1)
    cur_v = np.full((p, nt), -np.inf, np.float32)
    cur_i = np.zeros((p, nt), np.int32)
    lane = np.arange(nt)[None, :]
    for t in range(nt):
        mb = m1[:, t:t + 1]
        rank = (cur_v >= mb).sum(axis=1, keepdims=True)
        shift_v = np.concatenate([np.full((p, 1), -np.inf, np.float32),
                                  cur_v[:, :-1]], axis=1)
        shift_i = np.concatenate([np.zeros((p, 1), np.int32),
                                  cur_i[:, :-1]], axis=1)
        keep, ins = lane < rank, lane == rank
        cur_v = np.where(keep, cur_v, np.where(ins, mb, shift_v))
        cur_i = np.where(keep, cur_i, np.where(ins, t, shift_i)).astype(
            np.int32)
    return cur_v, cur_i


# ---------------------------------------------------------------- cases

@dataclass(frozen=True)
class Case:
    label: str                  # what the JAX case probes
    jax: tuple                  # its kernel(s) in tools/exp_kernel.py
    outs: tuple                 # the port's plane for each JAX output
    numpy: Callable             # the JAX kernel's function in numpy
    th: float | None = None     # cnt's threshold
    fold_to: int = 1            # a1_fold's fold width


CASES = {
    "reduce": Case("max reduce + aligned store", ("k_reduce_store",),
                   ("m1",), np_reduce),
    "fold": Case("max fold + aligned store", ("k_fold_store",), ("m1",),
                 lambda v: (np_max_fold(v),)),
    "full": Case("max reduce + full-width where store", ("k_reduce_full",),
                 ("m1",), np_reduce),
    "vi": Case("value + index where-fold", ("k_vi_fold",),
               ("m1", "a1_fold"), np_vi_fold),
    "cnt": Case("count > an input threshold", ("k_cnt",), ("cnt",),
                np_cnt(0.0), th=0.0),
    "vir": Case("value + first index by reductions", ("k_vi_reduce",),
                ("m1", "a1"), np_vi_reduce),
    "vih": Case("fold to 128 lanes, then first index", ("k_vi_hybrid",),
                ("m1", "a1_fold"), np_vi_hybrid, fold_to=128),
    "vif": Case("value + f32 index where-fold", ("k_vi_f32",),
                ("m1", "a1_fold"), np_vi_f32),
    "iso": Case("where-fold values; iota + max fold",
                ("k_fold_where", "k_iota_only"), ("m1", "m1"), np_iso),
    "vi2": Case("max fold, then min fold of the masked index",
                ("k_vi_twopass",), ("m1", "a1"), np_vi_twopass),
    "via": Case("max fold, then arithmetic-masked min fold",
                ("k_vi_arith",), ("m1", "a1"), np_vi_arith),
    "combo": Case("max fold + count > 0.5", ("k_fold_plus_cnt",),
                  ("m1", "cnt"), np_fold_plus_cnt, th=0.5),
    "namax": Case("native max + argmax", ("k_native_argmax",),
                  ("m1", "a1"), np_native_argmax),
    "namax2": Case("native argmax: first or last on ties",
                   ("k_native_argmax",), ("m1", "a1"), np_native_argmax),
    "top2": Case("max, argmax, masked 2nd, its summed lane, count > 0.5",
                 ("k_top2",), ("m1", "a1", "m2", "a2_sum", "cnt"), np_top2,
                 th=0.5),
    "t1": Case("count of lanes at the max", ("k_t1",), ("n_eq",), np_t1),
    "t2": Case("paired max/min top-2 fold", ("k_t2",), ("m1", "m2"),
               np_t2),
    "t3": Case("top-2 values by a top-k", ("k_t3",), ("m1", "m2"), np_t3),
    "t4": Case("arithmetic-masked 2nd and its summed lane", ("k_t4",),
               ("m2", "a2_sum"), np_t4),
    "topc": Case("running sorted insert of the tile maxima", ("k_topc",),
                 ("topc_v", "topc_i"), np_topc),
}


def tie_heavy(p: int = P_PAD, nt: int = NT, tr: int = TR, seed: int = 0):
    """round(normal * 2) in f32, the JAX probe's tie-heavy plane, with
    -0.0 made +0.0 (+ 0.0) so that equal values are equal bits."""
    rng = np.random.default_rng(seed)
    return (np.round(rng.normal(size=(p, nt * tr)) * 2).astype(np.float32)
            + np.float32(0))


def case_planes(case: Case, x: torch.Tensor, nt: int, reduce=None,
                topc=None):
    """The case's outputs from the port: tile_reduce's planes (tile_topc of
    the tile maxima for topc), in the JAX kernel's output order. reduce and
    topc default to the wrappers (kernel on the card, plain on the CPU)."""
    reduce = reduce or tred.tile_reduce
    topc = topc or tred.tile_topc
    if case.outs == ("topc_v", "topc_i"):
        m1 = reduce(x, None, n_tiles=nt, planes=("m1",))["m1"]
        return topc(m1)
    th = None
    if case.th is not None:
        th = torch.full((x.shape[0],), case.th, dtype=torch.float32,
                        device=x.device)
    planes = reduce(x, th, n_tiles=nt, planes=set(case.outs),
                    fold_to=case.fold_to)
    return tuple(planes[k] for k in case.outs)


def cuda_ms(fn, reps: int = 5) -> float:
    """Median device time of fn() by CUDA events."""
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def run_case(name: str, x_np: np.ndarray, nt: int, device,
             timing: bool = True) -> dict:
    """One case on x_np (P, NT*TR): the port's outputs against the plain
    versions and the numpy function. -> the case's JSON record."""
    case = CASES[name]
    dev = torch.device(device)
    x = torch.from_numpy(x_np).to(dev)
    got = case_planes(case, x, nt)
    plain = case_planes(case, x.cpu(), nt, reduce=tred.tile_reduce_plain,
                        topc=tred.tile_topc_plain)
    want = case.numpy(x_np.reshape(x_np.shape[0], nt, -1))
    got = [g.cpu().numpy() for g in got]
    rec = {"case": name, "label": case.label, "jax_kernels": list(case.jax),
           "planes": list(case.outs),
           "equal_plain": all(np.array_equal(g, q.numpy())
                              for g, q in zip(got, plain)),
           "equal_numpy": all(g.dtype == w.dtype and np.array_equal(g, w)
                              for g, w in zip(got, want))}
    if name == "namax2":
        x3 = x_np.reshape(x_np.shape[0], nt, -1)
        tr = x3.shape[-1]
        last = tr - 1 - x3[:, :, ::-1].argmax(axis=2)
        rec["first_argmax_frac"] = float((got[1] == x3.argmax(axis=2)).mean())
        rec["last_argmax_frac"] = float((got[1] == last).mean())
    if "a1_fold" in case.outs:
        x3 = x_np.reshape(x_np.shape[0], nt, -1)
        rec["fold_equals_first_argmax_frac"] = float(
            (got[1] == x3.argmax(axis=2)).mean())
    if timing and dev.type == "cuda":
        rec["kernel_ms"] = cuda_ms(lambda: case_planes(case, x, nt))
        rec["plain_ms"] = cuda_ms(lambda: case_planes(
            case, x, nt, reduce=tred.tile_reduce_plain,
            topc=tred.tile_topc_plain), reps=3)
    return rec


def main(cases=None, device="cuda", tr: int = TR, nt: int = NT,
         p: int = P_PAD, seed: int = 0) -> list[dict]:
    """Run the cases (default all) and print one JSON line each; raises if
    any case's planes differ from the plain versions or the numpy
    function."""
    dev = require_device(device)
    card = card_line(dev)
    print(card, file=sys.stderr, flush=True)
    x_np = tie_heavy(p, nt, tr, seed)
    out = []
    for name in cases or CASES:
        rec = run_case(name, x_np, nt, dev)
        rec.update(shape=[p, nt, tr], device=card)
        print(json.dumps(rec), flush=True)
        out.append(rec)
    bad = [r["case"] for r in out
           if not (r["equal_plain"] and r["equal_numpy"])]
    if bad:
        raise RuntimeError(f"cases differ from their plain or numpy "
                           f"functions: {bad}")
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m kmersgwas_tpu_torch.tools.exp_kernel",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*", default=["all"],
                    help=f"cases ({', '.join(CASES)}) or all")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--tr", type=int, default=TR, help="lanes per tile")
    ap.add_argument("--nt", type=int, default=NT, help="tiles per column")
    a = ap.parse_args(argv)
    names = list(CASES) if a.cases == ["all"] else a.cases
    unknown = [c for c in names if c not in CASES]
    if unknown:
        ap.error(f"unknown cases {unknown}")
    main(names, device=a.device, tr=a.tr, nt=a.nt)


if __name__ == "__main__":
    _cli()
