"""Association scores: plain PyTorch versions and the CUDA kernel wrappers
(port of kmersgwas_tpu/ops/score.py).

For phenotype column y and a k-mer's presence bits g over N used samples,
N1 = popcount(g) (src/kmers_multiple_databases.cpp:327-363):

    yigi  = sum_i y_i * g_i
    score = (N*yigi - N1*sum(y))^2 / (N*N1 - N1^2)     (0 if N1 or N0 < mac)

Scores are laid out transposed, (P, R), with padding rows (popcnt == 0) at
-inf, as the scan step consumes them.

Precision is explicit and never inherited from torch's global flags:
  "highest" — f32 products, f32 sums;
  "default" — y rounded to bf16, times the exact 0/1 bits, f32 sums (what
              kmersgwas_tpu/ops/score.py:88-106 documents for the TPU).
Both kernels take one f32 body: the wrappers round y before the launch.

Each kernel wrapper sends a CPU tensor to the plain version and a CUDA
tensor to the kernel; there is no other route and no fallback. Each keeps
a plain integer count of its kernel launches (`<wrapper>.launches`).
"""
from __future__ import annotations

import numpy as np
import torch

from . import _cuda
from .bitplanes import unpack_bits
from .topk import sort_desc_index_asc, top_k

PRECISIONS = ("default", "highest")


def prepare_phenotypes(values, n_lanes: int, device):
    """Phenotype columns (N, P) -> zero-padded (n_lanes, P) f32 tensor + the
    (P,) f32 column sums, on `device`. The sums are taken on the host in f64
    and rounded once, so they do not depend on the device."""
    y = np.asarray(values, dtype=np.float32)
    if y.ndim == 1:
        y = y[:, None]
    n, p = y.shape
    yp = np.zeros((n_lanes, p), np.float32)
    yp[:n] = y
    ysum = y.astype(np.float64).sum(axis=0).astype(np.float32)
    return (torch.from_numpy(yp).to(device),
            torch.from_numpy(ysum).to(device))


def gemm_operand(y_padded: torch.Tensor, precision: str) -> torch.Tensor:
    """The y the score GEMM multiplies: f32 as given ("highest") or
    rounded to bf16 and held in f32 ("default")."""
    if precision == "highest":
        return y_padded
    if precision == "default":
        return y_padded.to(torch.bfloat16).to(torch.float32)
    raise ValueError(f"precision must be one of {PRECISIONS}, "
                     f"got {precision!r}")


def score_epilogue_t(yigi_t, popcnt, y_sum, n_used: int, min_count: int):
    """(P, R) yigi -> (P, R) scores, padding rows -inf (the epilogue of
    kmersgwas_tpu/ops/score.py:492-499)."""
    n = float(n_used)
    n1 = popcnt[None, :]
    r = n * yigi_t - n1 * y_sum[:, None]
    denom = n * n1 - n1 * n1
    score = torch.where(denom > 0, (r * r) / denom, 0.0)
    ok = (n1 >= min_count) & ((n - n1) >= min_count)
    score = torch.where(ok, score, 0.0)
    return torch.where(n1 > 0, score, float("-inf"))


def scores_t_plain(packed, popcnt, y_padded, y_sum, *, n_used: int,
                   min_count: int, precision: str = "default"):
    """Plain scores (P, R): unpack, one f32 matmul, epilogue."""
    y = gemm_operand(y_padded, precision)
    if packed.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    g = unpack_bits(packed, torch.float32)                # (R, N_pad)
    yigi_t = torch.matmul(y.T, g.T)                       # (P, R)
    return score_epilogue_t(yigi_t, popcnt, y_sum, n_used,
                            min_count).contiguous()


def scores_and_bmax_plain(packed, popcnt, y_padded, y_sum, *, n_used: int,
                          min_count: int, block: int = 16,
                          precision: str = "default"):
    """-> (scores (P, R'), block maxima (P, R'/block)) with R' = R rounded
    up to `block` by -inf lanes; block b covers lanes [b*block, (b+1)*block)
    (the layout ops/topk.top_k_from_bmax reads)."""
    sc = scores_t_plain(packed, popcnt, y_padded, y_sum, n_used=n_used,
                        min_count=min_count, precision=precision)
    p, r = sc.shape
    if r % block:
        sc = torch.nn.functional.pad(sc, (0, block - r % block),
                                     value=float("-inf"))
    return sc, sc.view(p, -1, block).amax(dim=-1)


def topw_plain(packed, popcnt, y_padded, y_sum, thresh, *, n_used: int,
               min_count: int, tile_rows: int, cand_w: int,
               precision: str = "default"):
    """Plain version of the score_topw kernel: per tile of `tile_rows`
    lanes the exact top-3 (score, lane), lowest lane first on ties; then
    per column the top `cand_w` of those candidates by (score desc, lane
    asc), padded with (-inf, 0) when there are fewer, and the guard `ok`
    (no tile holds more than 3 lanes scoring > thresh). Mirrors
    kmersgwas_tpu/ops/scanstep.py `_topw_xla` with exact 2nd/3rd lanes.
    -> (values (P, W) f32, lanes (P, W) int32, ok (P,) bool)."""
    sc = scores_t_plain(packed, popcnt, y_padded, y_sum, n_used=n_used,
                        min_count=min_count, precision=precision)
    p, r = sc.shape
    assert r % tile_rows == 0 and tile_rows >= 3
    t = r // tile_rows
    s3 = sc.view(p, t, tile_rows)
    v3, a3 = top_k(s3, 3)                                 # (P, T, 3)
    ok = ((s3 > thresh[:, None, None]).sum(dim=-1) <= 3).all(dim=1)
    lanes = a3 + (torch.arange(t, device=sc.device) * tile_rows)[None, :, None]
    cat_v = v3.reshape(p, 3 * t)
    cat_g = lanes.reshape(p, 3 * t).to(torch.int32)
    if 3 * t < cand_w:
        pad = cand_w - 3 * t
        cat_v = torch.nn.functional.pad(cat_v, (0, pad), value=float("-inf"))
        cat_g = torch.nn.functional.pad(cat_g, (0, pad))
    v, g = sort_desc_index_asc(cat_v, cat_g)
    return v[:, :cand_w].contiguous(), g[:, :cand_w].contiguous(), ok


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _kernel_inputs(packed, popcnt, y_padded, y_sum, precision):
    """Validate a kernel call's inputs; -> (rows, w32, p, p_pad, y, ysum)
    with y/ysum zero-padded to the kernel's column chunk."""
    dev = packed.device
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous (R, W32) int32 tensor")
    rows, w32 = packed.shape
    n_pad, p = y_padded.shape
    if rows % _cuda.TILE_ROWS or rows >= 1 << 31:
        raise ValueError(f"rows ({rows}) must be a multiple of "
                         f"{_cuda.TILE_ROWS} and < 2^31")
    if n_pad != w32 * 32 or w32 % 4 or w32 > 384:
        raise ValueError(f"y_padded rows ({n_pad}) must be 32*W32 with "
                         f"W32 ({w32}) a multiple of 4 and <= 384")
    for name, t in (("popcnt", popcnt), ("y_padded", y_padded),
                    ("y_sum", y_sum)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
    if popcnt.shape != (rows,) or not popcnt.is_contiguous():
        raise ValueError("popcnt must be a contiguous (R,) tensor")
    p_pad = -(-p // _cuda.TILE_COLS) * _cuda.TILE_COLS
    y = torch.zeros((n_pad, p_pad), dtype=torch.float32, device=dev)
    y[:, :p] = gemm_operand(y_padded, precision)
    ys = torch.zeros(p_pad, dtype=torch.float32, device=dev)
    ys[:p] = y_sum
    return rows, w32, p, p_pad, y, ys


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"tensors on {t.device} have no kernel: CPU "
                         "tensors take the plain version, CUDA tensors "
                         "the kernel")


def score_batch_t_topw(packed, popcnt, y_padded, y_sum, thresh, *,
                       n_used: int, min_count: int, tile_rows: int,
                       cand_w: int, precision: str = "default"):
    """Per-batch scan kernel (csrc/score_topw.cu; replaces
    kmersgwas_tpu score_batch_t_pallas_topw): -> (cand_v (P, W) f32 sorted
    by (value desc, lane asc), cand_g (P, W) int32 batch lanes, ok (P,)
    bool). ok[c] means no `tile_rows`-row tile holds more than 3 lanes
    scoring > thresh[c]; the caller adds the W-th <= thresh check. On the
    card tile_rows must be the kernel's TILE_ROWS."""
    if packed.device.type == "cpu":
        return topw_plain(packed, popcnt, y_padded, y_sum, thresh,
                          n_used=n_used, min_count=min_count,
                          tile_rows=tile_rows, cand_w=cand_w,
                          precision=precision)
    _require_cuda(packed)
    if tile_rows != _cuda.TILE_ROWS:
        raise ValueError(f"the score_topw kernel captures per "
                         f"{_cuda.TILE_ROWS}-row tile, got {tile_rows}")
    if not 1 <= cand_w <= 1024:
        raise ValueError(f"cand_w must be in [1, 1024], got {cand_w}")
    rows, w32, p, p_pad, y, ys = _kernel_inputs(packed, popcnt, y_padded,
                                                y_sum, precision)
    dev = packed.device
    if thresh.shape != (p,) or thresh.dtype != torch.float32 \
            or thresh.device != dev:
        raise ValueError("thresh must be a (P,) float32 tensor on the card")
    th = torch.full((p_pad,), float("inf"), dtype=torch.float32, device=dev)
    th[:p] = thresh
    n_tiles = rows // _cuda.TILE_ROWS
    tile_v = torch.empty((p, 3 * n_tiles), dtype=torch.float32, device=dev)
    tile_g = torch.empty((p, 3 * n_tiles), dtype=torch.int32, device=dev)
    tile_cnt = torch.empty((p, n_tiles), dtype=torch.int32, device=dev)
    out_v = torch.empty((p, cand_w), dtype=torch.float32, device=dev)
    out_g = torch.empty((p, cand_w), dtype=torch.int32, device=dev)
    out_ok = torch.empty((p,), dtype=torch.int32, device=dev)
    sort_cap = 1 << (cand_w - 1).bit_length()
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.lib.kgt_score_topw(
            packed.data_ptr(), popcnt.data_ptr(), y.data_ptr(),
            ys.data_ptr(), th.data_ptr(), rows, w32, p, p_pad,
            float(n_used), float(min_count), cand_w, sort_cap,
            tile_v.data_ptr(), tile_g.data_ptr(), tile_cnt.data_ptr(),
            out_v.data_ptr(), out_g.data_ptr(), out_ok.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "score_topw")
    score_batch_t_topw.launches += 1
    return out_v, out_g, out_ok.bool()


score_batch_t_topw.launches = 0


def score_batch_t_bmax(packed, popcnt, y_padded, y_sum, *, n_used: int,
                       min_count: int, block: int = 16,
                       precision: str = "default"):
    """Exact-fallback kernel (csrc/score_bmax.cu; replaces kmersgwas_tpu
    score_batch_t_pallas_bmax): -> (scores (P, R) f32, maxima of the
    contiguous `block`-lane blocks (P, R/block)). On the card block is 16."""
    if packed.device.type == "cpu":
        return scores_and_bmax_plain(packed, popcnt, y_padded, y_sum,
                                     n_used=n_used, min_count=min_count,
                                     block=block, precision=precision)
    _require_cuda(packed)
    if block != 16:
        raise ValueError(f"the score_bmax kernel folds 16-lane blocks, "
                         f"got {block}")
    rows, w32, p, p_pad, y, ys = _kernel_inputs(packed, popcnt, y_padded,
                                                y_sum, precision)
    dev = packed.device
    scores = torch.empty((p, rows), dtype=torch.float32, device=dev)
    bmax = torch.empty((p, rows // 16), dtype=torch.float32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.lib.kgt_score_bmax(
            packed.data_ptr(), popcnt.data_ptr(), y.data_ptr(),
            ys.data_ptr(), rows, w32, p, p_pad, float(n_used),
            float(min_count), scores.data_ptr(), bmax.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "score_bmax")
    score_batch_t_bmax.launches += 1
    return scores, bmax


score_batch_t_bmax.launches = 0
