"""Per-(column, tile) reductions of an f32 plane and the running top-c over
tile maxima: the functions of the tile-reduction probes of
tools/exp_kernel.py (K9).

`tile_reduce` launches the tile_reduce kernel (csrc/tile_reduce.cu) for a
CUDA tensor and takes `tile_reduce_plain` for a CPU one; `tile_topc` and
`tile_topc_plain` likewise (the tile_topc kernel). Each wrapper counts its
launches (`<wrapper>.launches`).

For x of (P, NT*TR) f32 (tile t of column c is x[c, t*TR:(t+1)*TR]) the
planes, each (P, NT), are (PLANES):
  m1       the tile max;
  a1       the lowest lane at the max (int32);
  a1_fold  the lane that wins the halving fold of k_vi_fold
           (tools/exp_kernel.py:86-95) down to `fold_to` lanes, then the
           lowest surviving lane at the max (k_vi_hybrid folds to 128); it
           is not the first argmax in general: the fold's pairs are lanes j
           and j + width/2, so ties go to the lane first in bit-reversed
           order;
  m2       the max after lane a1 is set to -inf (the 2nd of a descending
           sort);
  a2_sum   the sum of the lanes equal to m2 after that mask (the
           sum-encoded lane of k_top2 :568 and k_t4 :653);
  n_eq     the count of lanes equal to m1 (k_t1);
  cnt      the count of lanes > th[c] (int32).
Signed zeros compare equal; the functions are defined for finite x.
"""
from __future__ import annotations

import torch

from . import _cuda

PLANES = ("m1", "a1", "a1_fold", "m2", "a2_sum", "n_eq", "cnt")
_FLOAT_PLANES = ("m1", "m2")
MAX_TILE_LANES = 4096           # tile_reduce: TR a power of two in [4, 4096]
MAX_TOPC_TILES = 2048           # tile_topc: NT <= 2048


def _check(x: torch.Tensor, n_tiles: int, planes) -> int:
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError("x must be a contiguous (P, NT*TR) float32 tensor")
    bad = set(planes) - set(PLANES)
    if bad:
        raise ValueError(f"unknown planes {sorted(bad)}; known: {PLANES}")
    if n_tiles <= 0 or x.shape[1] % n_tiles:
        raise ValueError(f"{x.shape[1]} lanes do not split into {n_tiles} "
                         "tiles")
    return x.shape[1] // n_tiles


def tile_reduce_plain(x: torch.Tensor, th: torch.Tensor | None, *,
                      n_tiles: int, planes=PLANES, fold_to: int = 1) -> dict:
    """The plain version of tile_reduce: -> {plane: (P, NT) tensor}."""
    tr = _check(x, n_tiles, planes)
    p = x.shape[0]
    s = x.view(p, n_tiles, tr)
    lane = torch.arange(tr, device=x.device)
    out = {}
    m1 = s.amax(dim=-1)
    big = torch.tensor(tr, device=x.device)
    a1 = torch.where(s == m1[..., None], lane, big).amin(dim=-1)
    if "m1" in planes:
        out["m1"] = m1
    if "a1" in planes:
        out["a1"] = a1.to(torch.int32)
    if "a1_fold" in planes:
        # the fold as k_vi_fold writes it: keep the left half where
        # left >= right, halving the width down to fold_to
        v, i = s, lane.expand(p, n_tiles, tr)
        width = tr
        while width > fold_to:
            half = width // 2
            keep = v[..., :half] >= v[..., half:width]
            v = torch.where(keep, v[..., :half], v[..., half:width])
            i = torch.where(keep, i[..., :half], i[..., half:width])
            width = half
        out["a1_fold"] = torch.where(v == m1[..., None], i, big).amin(
            dim=-1).to(torch.int32)
    if "m2" in planes or "a2_sum" in planes:
        s2 = s.scatter(-1, a1[..., None], float("-inf"))
        m2 = s2.amax(dim=-1)
        if "m2" in planes:
            out["m2"] = m2
        if "a2_sum" in planes:
            out["a2_sum"] = torch.where(s2 == m2[..., None], lane, 0).sum(
                dim=-1).to(torch.int32)
    if "n_eq" in planes:
        out["n_eq"] = (s == m1[..., None]).sum(dim=-1).to(torch.int32)
    if "cnt" in planes:
        out["cnt"] = (s > th[:, None, None]).sum(dim=-1).to(torch.int32)
    return {k: out[k].contiguous() for k in PLANES if k in out}


def tile_reduce(x: torch.Tensor, th: torch.Tensor | None, *, n_tiles: int,
                planes=PLANES, fold_to: int = 1) -> dict:
    """The (P, NT) planes named in `planes` (see the module docstring) of x
    (P, NT*TR) f32; th (P,) f32 is read for "cnt" only. A CUDA tensor
    launches the tile_reduce kernel (TR a power of two in [4, 4096]); a CPU
    tensor takes tile_reduce_plain."""
    tr = _check(x, n_tiles, planes)
    if x.device.type == "cpu":
        return tile_reduce_plain(x, th, n_tiles=n_tiles, planes=planes,
                                 fold_to=fold_to)
    if x.device.type != "cuda":
        raise ValueError(f"tensors on {x.device} have no kernel")
    if tr < 4 or tr > MAX_TILE_LANES or tr & (tr - 1) or fold_to < 1:
        raise ValueError(f"tile lanes ({tr}) must be a power of two in "
                         f"[4, {MAX_TILE_LANES}], fold_to >= 1")
    p = x.shape[0]
    if x.data_ptr() % 16:
        raise ValueError("x must be 16-byte aligned")
    if "cnt" in planes and (th is None or th.shape != (p,)
                            or th.dtype != torch.float32
                            or th.device != x.device):
        raise ValueError("cnt needs th, a (P,) float32 tensor on x's device")
    out = {k: torch.empty((p, n_tiles), device=x.device,
                          dtype=torch.float32 if k in _FLOAT_PLANES
                          else torch.int32)
           for k in PLANES if k in planes}
    th_ptr = th.contiguous().data_ptr() if "cnt" in planes else None
    lib = _cuda.library()
    with torch.cuda.device(x.device):
        rc = lib.lib.kgt_tile_reduce(
            x.data_ptr(), th_ptr, p, n_tiles, tr, fold_to,
            *(out[k].data_ptr() if k in out else None for k in PLANES),
            torch.cuda.current_stream(x.device).cuda_stream)
    _cuda.check(lib, rc, "tile_reduce")
    tile_reduce.launches += 1
    return out


tile_reduce.launches = 0


def tile_topc_plain(m1: torch.Tensor):
    """The plain version of tile_topc: k_topc's sorted insert
    (tools/exp_kernel.py:699-714) written out, one tile per step."""
    p, nt = m1.shape
    cur_v = torch.full((p, nt), float("-inf"), dtype=m1.dtype,
                       device=m1.device)
    cur_i = torch.zeros((p, nt), dtype=torch.int32, device=m1.device)
    lane = torch.arange(nt, device=m1.device)[None, :]
    for t in range(nt):
        mb = m1[:, t:t + 1]
        rank = (cur_v >= mb).sum(dim=1, keepdim=True)
        shift_v = torch.cat([torch.full_like(cur_v[:, :1], float("-inf")),
                             cur_v[:, :-1]], dim=1)
        shift_i = torch.cat([torch.zeros_like(cur_i[:, :1]), cur_i[:, :-1]],
                            dim=1)
        keep, ins = lane < rank, lane == rank
        cur_v = torch.where(keep, cur_v, torch.where(ins, mb, shift_v))
        cur_i = torch.where(keep, cur_i, torch.where(ins, t, shift_i))
    return cur_v, cur_i


def tile_topc(m1: torch.Tensor):
    """(P, NT) f32 tile maxima -> (values, tile indices), each (P, NT): the
    maxima in descending order, the earlier tile first on ties (a -inf
    maximum is dropped and its slot keeps (-inf, 0)). A CUDA tensor
    launches the tile_topc kernel (NT <= 2048); a CPU tensor takes
    tile_topc_plain."""
    if m1.dtype != torch.float32 or m1.dim() != 2 or not m1.is_contiguous():
        raise ValueError("m1 must be a contiguous (P, NT) float32 tensor")
    if m1.device.type == "cpu":
        return tile_topc_plain(m1)
    if m1.device.type != "cuda":
        raise ValueError(f"tensors on {m1.device} have no kernel")
    p, nt = m1.shape
    if not 0 < nt <= MAX_TOPC_TILES:
        raise ValueError(f"NT ({nt}) must be in [1, {MAX_TOPC_TILES}]")
    out_v = torch.empty_like(m1)
    out_i = torch.empty((p, nt), dtype=torch.int32, device=m1.device)
    lib = _cuda.library()
    with torch.cuda.device(m1.device):
        rc = lib.lib.kgt_tile_topc(
            m1.data_ptr(), p, nt, out_v.data_ptr(), out_i.data_ptr(),
            torch.cuda.current_stream(m1.device).cuda_stream)
    _cuda.check(lib, rc, "tile_topc")
    tile_topc.launches += 1
    return out_v, out_i


tile_topc.launches = 0
