"""Association scores: plain PyTorch versions and the CUDA kernel wrappers
(port of kmersgwas_tpu/ops/score.py).

For phenotype column y and a k-mer's presence bits g over N used samples,
N1 = popcount(g) (src/kmers_multiple_databases.cpp:327-363):

    yigi  = sum_i y_i * g_i
    score = (N*yigi - N1*sum(y))^2 / (N*N1 - N1^2)     (0 if N1 or N0 < mac)

Scores are laid out transposed, (P, R), with padding rows (popcnt == 0) at
-inf, as the scan step consumes them; `score_batch` alone gives the
row-major (R, P) scores of the reference's `score_batch`, with no padding
mask.

Precision is explicit and never inherited from torch's global flags:
  "highest" — f32 products, f32 sums;
  "default" — y rounded to bf16, times the exact 0/1 bits, f32 sums (what
              kmersgwas_tpu/ops/score.py:88-106 documents for the TPU).
Every score kernel runs on one body, on the tensor cores
(csrc/score_wgmma.cuh): the scan step's kernels (K1 score_topw, K3
score_tilemax, K8 score_parity through K1's tile launch) and the score
plane's three modes (csrc/score_plane.cu: K2 score_bmax, K4 score_t and
the row-major K5 score_rows). y goes in as bf16 planes (`bf16_planes`: one
at "default", three summing to y at "highest") in the kernel's layout
(`wgmma_operand`).

Each kernel wrapper sends a CPU tensor to the plain version and a CUDA
tensor to the kernel; there is no other route and no fallback. Each keeps
a plain integer count of its kernel launches (`<wrapper>.launches`). The
scan step's wrappers (`score_batch_t_topw`, `score_batch_t_tilemax`,
`score_batch_t_bmax`) are spans of their names (utils.span).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import count, span
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


def bf16_planes(y_padded: torch.Tensor, precision: str) -> torch.Tensor:
    """The y of the tensor-core kernels as bf16 planes, held in f32 (each
    plane is exact in bf16): (1, N, P) bf16(y) at "default"; (3, N, P) at
    "highest", hi = bf16(y), mid = bf16(y - hi), lo = bf16(y - hi - mid).
    Each residual is exact in f32 and the last has at most 8 significant
    bits, so hi + mid + lo == y exactly (in real arithmetic; an f32 sum of
    the three can round)."""
    if precision == "default":
        return gemm_operand(y_padded, precision)[None]
    if precision != "highest":
        gemm_operand(y_padded, precision)               # raises
    hi = y_padded.to(torch.bfloat16).to(torch.float32)
    r = y_padded - hi
    mid = r.to(torch.bfloat16).to(torch.float32)
    lo = (r - mid).to(torch.bfloat16).to(torch.float32)
    return torch.stack([hi, mid, lo])


def column_chunks(p: int) -> tuple[int, int]:
    """(chunk width nc, number of chunks n_cc) of the tensor-core kernels
    for p columns: p padded to a multiple of 8, cut into the fewest chunks
    of at most the widest of _cuda.WGMMA_CHUNKS (128), each the smallest
    width there that holds an equal share (P=101 -> one chunk of 104;
    P=1013 -> eight of 128)."""
    p8 = -(-p // 8) * 8
    n_cc = -(-p8 // _cuda.WGMMA_CHUNKS[-1])
    share = -(-p8 // n_cc)
    return next(c for c in _cuda.WGMMA_CHUNKS if c >= share), n_cc


def wgmma_operand(y_padded: torch.Tensor, precision: str,
                  nc: int) -> torch.Tensor:
    """The B operand of the tensor-core kernels (csrc/score_wgmma.cuh) for
    (N_pad, P) phenotypes: the bf16 planes of `bf16_planes`, columns
    zero-padded to n_cc * nc, laid out as (n_cc, N_pad / 64, planes, nc / 8,
    8, 8, 8): per column chunk and 64-sample ring stage one contiguous block
    per plane of 8x8 core matrices (8 columns x 8 samples, samples
    contiguous), the 8 sample-blocks of a column block adjacent (128 bytes
    apart) and column blocks 1024 bytes apart. Element (column chunk cc,
    stage kc, plane l, column block nb, sample block kb, column n8, sample
    k8) is plane l's y[64 kc + 8 kb + k8][cc nc + 8 nb + n8]."""
    n_pad, p = y_padded.shape
    kc = _cuda.WGMMA_KC
    if n_pad % kc or nc % 8:
        raise ValueError(f"N_pad ({n_pad}) must be a multiple of {kc} and "
                         f"the chunk ({nc}) of 8")
    planes = bf16_planes(y_padded, precision)
    n_cc = -(-p // nc)
    y = torch.zeros((planes.shape[0], n_pad, n_cc * nc), dtype=torch.float32,
                    device=y_padded.device)
    y[:, :, :p] = planes
    # (plane, stage, kb, k8, chunk, nb, n8) -> (chunk, stage, plane, nb, kb,
    # n8, k8)
    y = y.view(planes.shape[0], n_pad // kc, kc // 8, 8, n_cc, nc // 8, 8)
    return y.permute(4, 1, 0, 5, 2, 6, 3).to(torch.bfloat16).contiguous()


def _epilogue(yigi, n1, y_sum, n_used: int, min_count: int):
    """The score of yigi given n1 and y_sum broadcast to its layout; 0
    where the MAC test fails."""
    n = float(n_used)
    r = n * yigi - n1 * y_sum
    denom = n * n1 - n1 * n1
    score = torch.where(denom > 0, (r * r) / denom, 0.0)
    ok = (n1 >= min_count) & ((n - n1) >= min_count)
    return torch.where(ok, score, 0.0)


def score_epilogue(yigi, popcnt, y_sum, n_used: int, min_count: int):
    """(R, P) yigi -> (R, P) scores, 0 where the MAC test fails, no padding
    mask (kmersgwas_tpu/ops/score.py `_score_epilogue`)."""
    return _epilogue(yigi, popcnt[:, None], y_sum[None, :], n_used,
                     min_count)


def score_epilogue_t(yigi_t, popcnt, y_sum, n_used: int, min_count: int):
    """(P, R) yigi -> (P, R) scores, padding rows -inf (the epilogue of
    kmersgwas_tpu/ops/score.py:492-499)."""
    n1 = popcnt[None, :]
    score = _epilogue(yigi_t, n1, y_sum[:, None], n_used, min_count)
    return torch.where(n1 > 0, score, float("-inf"))


def scores_plain(packed, popcnt, y_padded, y_sum, *, n_used: int,
                 min_count: int, precision: str = "default"):
    """Plain row-major scores (R, P): unpack, one f32 matmul, epilogue (the
    function of kmersgwas_tpu/ops/score.py `score_batch`)."""
    y = gemm_operand(y_padded, precision)
    if packed.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    g = unpack_bits(packed, torch.float32)                # (R, N_pad)
    return score_epilogue(torch.matmul(g, y), popcnt, y_sum, n_used,
                          min_count).contiguous()


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


def _tile_top3(sc, thresh, tile_rows: int):
    """Per tile of `tile_rows` lanes of (P, R) scores: the exact top-3
    (values (P, T, 3), batch lanes (P, T, 3) int32), lowest lane first on
    ties, and the guard ok (P,): no tile holds more than 3 lanes > thresh."""
    p, r = sc.shape
    assert r % tile_rows == 0 and tile_rows >= 3
    t = r // tile_rows
    s3 = sc.view(p, t, tile_rows)
    v3, a3 = top_k(s3, 3)                                 # (P, T, 3)
    ok = ((s3 > thresh[:, None, None]).sum(dim=-1) <= 3).all(dim=1)
    lanes = a3 + (torch.arange(t, device=sc.device) * tile_rows)[None, :, None]
    return v3, lanes.to(torch.int32), ok


def _select(cat_v, cat_g, w: int):
    """Top `w` of (P, n) candidates by (value desc, lane asc), padded with
    (-inf, 0) when there are fewer."""
    if cat_v.shape[1] < w:
        pad = w - cat_v.shape[1]
        cat_v = torch.nn.functional.pad(cat_v, (0, pad), value=float("-inf"))
        cat_g = torch.nn.functional.pad(cat_g, (0, pad))
    v, g = sort_desc_index_asc(cat_v, cat_g)
    return v[:, :w].contiguous(), g[:, :w].contiguous()


def topw_select_plain(tile_v, tile_g, tile_cnt, w: int, lists: int = 1):
    """Plain version of K1's select launch on a batch's tile candidates
    (tile_v (P, 3T) f32, tile_g (P, 3T) int32 lanes, tile_cnt (P, T)): per
    list the top `w` by (score desc, lane asc), padded with (-inf, 0), and
    ok (P,): every tile holds at most 3 lanes > thresh. With two lists (K8)
    list L holds the tiles t with t % 2 == L. -> (values (lists, P, w),
    lanes (lists, P, w), ok)."""
    p = tile_v.shape[0]
    v3, g3 = tile_v.view(p, -1, 3), tile_g.view(p, -1, 3)
    outs = [_select(v3[:, l::lists].reshape(p, -1),
                    g3[:, l::lists].reshape(p, -1), w) for l in range(lists)]
    return (torch.stack([v for v, _ in outs]),
            torch.stack([g for _, g in outs]), (tile_cnt <= 3).all(dim=1))


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
    v3, lanes, ok = _tile_top3(sc, thresh, tile_rows)
    p = sc.shape[0]
    return (*_select(v3.reshape(p, -1), lanes.reshape(p, -1), cand_w), ok)


def parity_plain(packed, popcnt, y_padded, y_sum, thresh, *, n_used: int,
                 min_count: int, tile_rows: int = 4096, w: int = 128,
                 precision: str = "default"):
    """Plain version of the score_parity kernel (the two-list epilogue of
    tools/prof_r5_epi.py `_parity_kernel`, :419-491): per probe tile of
    `tile_rows` lanes the exact top-3 (score, lane); list A is the top `w`
    of the even tiles' candidates, list B of the odd tiles', each by (score
    desc, lane asc) and padded with (-inf, 0); ok: no probe tile holds more
    than 3 lanes scoring > thresh. -> (va, ga, vb, gb, ok): (P, w) f32 and
    int32 batch lanes, (P,) bool."""
    sc = scores_t_plain(packed, popcnt, y_padded, y_sum, n_used=n_used,
                        min_count=min_count, precision=precision)
    v3, lanes, ok = _tile_top3(sc, thresh, tile_rows)
    p = sc.shape[0]
    va, ga = _select(v3[:, 0::2].reshape(p, -1), lanes[:, 0::2].reshape(p, -1),
                     w)
    vb, gb = _select(v3[:, 1::2].reshape(p, -1), lanes[:, 1::2].reshape(p, -1),
                     w)
    return va, ga, vb, gb, ok


def tilemax_from_scores(sc, thresh, tile_rows: int):
    """The nine per-(column, tile) planes of the score_tilemax kernel from
    full (P, R) scores (see tilemax_plain)."""
    p, r = sc.shape
    assert r % tile_rows == 0 and tile_rows >= 3
    s3 = sc.view(p, r // tile_rows, tile_rows)
    v, a = top_k(s3, 3)                                   # (P, T, 3)
    v0, v1, v2 = v.unbind(-1)
    neg_inf = float("-inf")

    def count(value):
        return (s3 == value[..., None]).sum(dim=-1)
    # s2 drops lane targ (score v0) and holds -inf there; s3 also drops
    # lane targ2 (score v1)
    n2 = count(v1) - (v0 == v1).long() + (v1 == neg_inf).long()
    n3 = (count(v2) - (v0 == v2).long() - (v1 == v2).long()
          + 2 * (v2 == neg_inf).long())
    cnt = (s3 > thresh[:, None, None]).sum(dim=-1)
    a = a.to(torch.int32)
    return tuple(x.contiguous() for x in (
        v0, a[..., 0], v1, a[..., 1], v2, a[..., 2], n2.to(torch.int32),
        n3.to(torch.int32), cnt.to(torch.int32)))


def tilemax_plain(packed, popcnt, y_padded, y_sum, thresh, *, n_used: int,
                  min_count: int, tile_rows: int,
                  precision: str = "default"):
    """Plain version of the score_tilemax kernel: per column c and tile t
    of `tile_rows` lanes, with s the tile's scores,
      (tmax, targ), (tmax2, targ2), (tmax3, targ3) — the first three lanes
          of the tile by (score desc, lane asc), lanes within the tile;
      n2, n3 — #{l : s2[l] == tmax2}, #{l : s3[l] == tmax3}, where s2 is s
          with lane targ at -inf and s3 is s2 with lane targ2 at -inf;
      cnt — #{l : s[l] > thresh[c]}.
    -> nine (P, T) planes, f32 values and int32 lanes and counts.

    The reference's XLA mirror (kmersgwas_tpu/ops/scanstep.py `_tilemax`)
    sum-encodes targ2/targ3; every plane here equals its plane wherever the
    reference's is meaningful: tmax, targ, tmax2, n2 and cnt everywhere;
    targ2, tmax3 and n3 where n2 == 1; targ3 where n2 == n3 == 1."""
    sc = scores_t_plain(packed, popcnt, y_padded, y_sum, n_used=n_used,
                        min_count=min_count, precision=precision)
    return tilemax_from_scores(sc, thresh, tile_rows)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

def _check_batch(packed, popcnt, y_padded, y_sum):
    """Validate a kernel call's batch; -> (rows, w32, p)."""
    dev = packed.device
    if packed.dtype != torch.int32 or packed.dim() != 2 \
            or not packed.is_contiguous():
        raise ValueError("packed must be a contiguous (R, W32) int32 tensor")
    rows, w32 = packed.shape
    if y_padded.dim() != 2:
        raise ValueError("y_padded must be a (N_pad, P) tensor")
    n_pad, p = y_padded.shape
    if rows % _cuda.TILE_ROWS or not 0 < rows < 1 << 31:
        raise ValueError(f"rows ({rows}) must be a positive multiple of "
                         f"{_cuda.TILE_ROWS} and < 2^31")
    if n_pad != w32 * 32 or w32 % 4 or not 0 < w32 <= 384:
        raise ValueError(f"y_padded rows ({n_pad}) must be 32*W32 with "
                         f"W32 ({w32}) a multiple of 4 in [4, 384]")
    if p < 1:
        raise ValueError("y_padded must hold at least one column")
    for name, t in (("popcnt", popcnt), ("y_padded", y_padded),
                    ("y_sum", y_sum)):
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}")
    if popcnt.shape != (rows,) or not popcnt.is_contiguous():
        raise ValueError("popcnt must be a contiguous (R,) tensor")
    if y_sum.shape != (p,):
        raise ValueError(f"y_sum must be a ({p},) tensor")
    return rows, w32, p


def _plane_inputs(packed, popcnt, y_padded, y_sum, precision):
    """Validate a tensor-core kernel call's batch; -> (rows, w32, p, b,
    ysum) with b the `wgmma_operand` of the call's column chunk and ysum
    padded with 0 to its n_cc * nc columns. All a score-plane kernel
    (score_bmax, score_t, score_rows) takes."""
    rows, w32, p = _check_batch(packed, popcnt, y_padded, y_sum)
    nc, _ = column_chunks(p)
    b = wgmma_operand(y_padded, precision, nc)
    ys = torch.zeros(b.shape[0] * nc, dtype=torch.float32,
                     device=packed.device)
    ys[:p] = y_sum
    return rows, w32, p, b, ys


def _wgmma_inputs(packed, popcnt, y_padded, y_sum, thresh, precision):
    """Validate a thresholded tensor-core kernel call's inputs (score_topw,
    score_tilemax, score_parity); -> (rows, w32, p, b, ysum, thresh): those
    of `_plane_inputs` and thresh padded with +inf to the same columns."""
    rows, w32, p, b, ys = _plane_inputs(packed, popcnt, y_padded, y_sum,
                                        precision)
    dev = packed.device
    if thresh.device != dev or thresh.dtype != torch.float32 \
            or thresh.shape != (p,):
        raise ValueError(f"thresh must be a ({p},) float32 tensor on {dev}")
    th = torch.full(ys.shape, float("inf"), dtype=torch.float32, device=dev)
    th[:p] = thresh
    return rows, w32, p, b, ys, th


def _chunk_args(b) -> tuple[int, int, int]:
    """(nc, n_cc, planes) of a `wgmma_operand`."""
    return b.shape[3] * 8, b.shape[0], b.shape[2]


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"tensors on {t.device} have no kernel: CPU "
                         "tensors take the plain version, CUDA tensors "
                         "the kernel")


def _plane_kernel(packed, popcnt, y_padded, y_sum, *, n_used: int,
                  min_count: int, precision: str, entry: str):
    """Launch one mode of csrc/score_plane.cu: kgt_score_bmax -> ((P, R)
    scores, (P, R/16) block maxima); kgt_score_t -> ((P, R) scores, None);
    kgt_score_rows -> ((R, P) scores, None)."""
    rows, w32, p, b, ys = _plane_inputs(packed, popcnt, y_padded, y_sum,
                                        precision)
    dev = packed.device
    shape = (rows, p) if entry == "kgt_score_rows" else (p, rows)
    scores = torch.empty(shape, dtype=torch.float32, device=dev)
    with_bmax = entry == "kgt_score_bmax"
    bmax = (torch.empty((p, rows // 16), dtype=torch.float32, device=dev)
            if with_bmax else None)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = getattr(lib.lib, entry)(
            packed.data_ptr(), popcnt.data_ptr(), b.data_ptr(),
            ys.data_ptr(), rows, w32, p, *_chunk_args(b), float(n_used),
            float(min_count), scores.data_ptr(),
            *((bmax.data_ptr(),) if with_bmax else ()),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, entry)
    return scores, bmax


def score_batch_t(packed, popcnt, y_padded, y_sum, *, n_used: int,
                  min_count: int, precision: str = "default"):
    """Transposed scores (csrc/score_plane.cu `kgt_score_t`, on the
    tensor-core body; replaces kmersgwas_tpu score_batch_t_pallas): -> (P,
    R) f32, padding rows (popcnt == 0) at -inf. The scoring of the plain
    scan step (ops/scanstep.scan_step). On the card, the shapes
    `_plane_inputs` takes."""
    if packed.device.type == "cpu":
        return scores_t_plain(packed, popcnt, y_padded, y_sum, n_used=n_used,
                              min_count=min_count, precision=precision)
    _require_cuda(packed)
    out, _ = _plane_kernel(packed, popcnt, y_padded, y_sum, n_used=n_used,
                           min_count=min_count, precision=precision,
                           entry="kgt_score_t")
    score_batch_t.launches += 1
    return out


score_batch_t.launches = 0


def score_batch(packed, popcnt, y_padded, y_sum, *, n_used: int,
                min_count: int, precision: str = "default"):
    """Row-major scores (csrc/score_plane.cu `kgt_score_rows`, on the
    tensor-core body; replaces kmersgwas_tpu score_batch_pallas): -> (R, P)
    f32, 0 where the MAC test fails and no padding mask. At the same P the
    scores are score_batch_t's, transposed, with -inf as 0. On the card,
    the shapes `_plane_inputs` takes."""
    if packed.device.type == "cpu":
        return scores_plain(packed, popcnt, y_padded, y_sum, n_used=n_used,
                            min_count=min_count, precision=precision)
    _require_cuda(packed)
    out, _ = _plane_kernel(packed, popcnt, y_padded, y_sum, n_used=n_used,
                           min_count=min_count, precision=precision,
                           entry="kgt_score_rows")
    score_batch.launches += 1
    return out


score_batch.launches = 0


SELECT_PATHS = ("sort", "stream")


def select_path(n_tiles: int, lists: int, w: int) -> str:
    """The path K1's select launch takes over n_tiles tiles of candidates
    in `lists` lists (K8: 2, tiles alternating) at w, a name of
    SELECT_PATHS, as csrc/score_topw.cuh `select_path` picks it from the
    lists' candidate counts: "sort" sorts each list whole, padded to w,
    where the longer holds at most 1024 or the shorter fewer than w;
    "stream" bounds the w-th score and sorts the candidates above it.
    Asks the kernel library (card only); no sync."""
    path = _cuda.library().lib.kgt_select_path(n_tiles, lists, w)
    if path < 0:
        raise ValueError(f"no select for n_tiles={n_tiles}, lists={lists}, "
                         f"w={w}")
    return SELECT_PATHS[path]


def _count_select(n_tiles: int, lists: int, w: int) -> None:
    """Counts a select launch as `topw_select.<path>` (utils.count)."""
    count(f"topw_select.{select_path(n_tiles, lists, w)}")


_FALLBACKS: dict = {}


def _fallback_counter(dev) -> torch.Tensor:
    """The device integer the select's radix fallback adds 1 to a block
    (one a device, made at its first launch; a bare "cuda" is the current
    device)."""
    d = torch.device(dev)
    if d.index is None:
        d = torch.device(d.type, torch.cuda.current_device())
    if d not in _FALLBACKS:
        _FALLBACKS[d] = torch.zeros(1, dtype=torch.int32, device=d)
    return _FALLBACKS[d]


def select_fallbacks(dev) -> int:
    """Blocks of K1's select (and K8's) on `dev` that took the radix
    fallback since the process began. Synchronizes: for tests and
    chip_smoke.py, never the step."""
    return int(_fallback_counter(dev).item())


def topw_select(tile_v, tile_g, tile_cnt, w: int, lists: int = 1):
    """K1's select launch alone (csrc/score_topw.cu `kgt_topw_select`) on
    tile candidates as its tile launch writes them: -> topw_select_plain's
    (values (lists, P, w), lanes, ok). CPU tensors take the plain version.
    On the card: float32 tile_v and int32 tile_g (P, 3T), int32 tile_cnt
    (P, T), contiguous; lanes unique within a column; 1 <= w <= 1024."""
    if tile_v.device.type == "cpu":
        return topw_select_plain(tile_v, tile_g, tile_cnt, w, lists)
    _require_cuda(tile_v)
    p, t = tile_cnt.shape
    dev = tile_v.device
    for name, x, dt, shape in (("tile_v", tile_v, torch.float32, (p, 3 * t)),
                               ("tile_g", tile_g, torch.int32, (p, 3 * t)),
                               ("tile_cnt", tile_cnt, torch.int32, (p, t))):
        if x.device != dev or x.dtype != dt or x.shape != shape \
                or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {shape} {dt} "
                             f"tensor on {dev}")
    if not 1 <= w <= 1024 or lists not in (1, 2):
        raise ValueError(f"w must be in [1, 1024] and lists 1 or 2, got "
                         f"{w}, {lists}")
    out_v = torch.empty((lists, p, w), dtype=torch.float32, device=dev)
    out_g = torch.empty((lists, p, w), dtype=torch.int32, device=dev)
    out_ok = torch.empty((p,), dtype=torch.int32, device=dev)
    _count_select(t, lists, w)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.lib.kgt_topw_select(
            tile_v.data_ptr(), tile_g.data_ptr(), tile_cnt.data_ptr(), t, p,
            lists, w, out_v.data_ptr(), out_g.data_ptr(),
            out_ok.data_ptr(), _fallback_counter(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "topw_select")
    return out_v, out_g, out_ok.bool()


@span("score_batch_t_topw")
def score_batch_t_topw(packed, popcnt, y_padded, y_sum, thresh, *,
                       n_used: int, min_count: int, tile_rows: int,
                       cand_w: int, precision: str = "default"):
    """Per-batch scan kernel (csrc/score_topw.cu; replaces
    kmersgwas_tpu score_batch_t_pallas_topw): -> (cand_v (P, W) f32 sorted
    by (value desc, lane asc), cand_g (P, W) int32 batch lanes, ok (P,)
    bool). ok[c] means no `tile_rows`-row tile holds more than 3 lanes
    scoring > thresh[c]; the caller adds the W-th <= thresh check. On the
    card (tensor-core body, csrc/score_wgmma.cuh) tile_rows must be the
    kernel's TILE_ROWS, 1 <= cand_w <= 1024, and the shapes those
    `_wgmma_inputs` takes."""
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
    rows, w32, p, b, ys, th = _wgmma_inputs(packed, popcnt, y_padded, y_sum,
                                            thresh, precision)
    dev = packed.device
    n_tiles = rows // _cuda.TILE_ROWS
    tile_v = torch.empty((p, 3 * n_tiles), dtype=torch.float32, device=dev)
    tile_g = torch.empty((p, 3 * n_tiles), dtype=torch.int32, device=dev)
    tile_cnt = torch.empty((p, n_tiles), dtype=torch.int32, device=dev)
    out_v = torch.empty((p, cand_w), dtype=torch.float32, device=dev)
    out_g = torch.empty((p, cand_w), dtype=torch.int32, device=dev)
    out_ok = torch.empty((p,), dtype=torch.int32, device=dev)
    _count_select(n_tiles, 1, cand_w)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.lib.kgt_score_topw(
            packed.data_ptr(), popcnt.data_ptr(), b.data_ptr(),
            ys.data_ptr(), th.data_ptr(), rows, w32, p, *_chunk_args(b),
            float(n_used), float(min_count), cand_w,
            tile_v.data_ptr(), tile_g.data_ptr(), tile_cnt.data_ptr(),
            out_v.data_ptr(), out_g.data_ptr(), out_ok.data_ptr(),
            _fallback_counter(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "score_topw")
    score_batch_t_topw.launches += 1
    return out_v, out_g, out_ok.bool()


score_batch_t_topw.launches = 0


def score_batch_t_parity(packed, popcnt, y_padded, y_sum, thresh, *,
                         n_used: int, min_count: int, tile_rows: int = 4096,
                         w: int = 128, precision: str = "default"):
    """Two-list top-W epilogue of the step-budget probe
    (csrc/score_parity.cu; replaces tools/prof_r5_epi.py `_parity_kernel`):
    -> (va, ga, vb, gb, ok) as parity_plain defines them. On the card
    tile_rows must be a multiple of the kernel's TILE_ROWS dividing the
    batch rows, 1 <= w <= 1024, and the shapes `_wgmma_inputs` takes (the
    kernel runs K1's tile launch)."""
    if packed.device.type == "cpu":
        return parity_plain(packed, popcnt, y_padded, y_sum, thresh,
                            n_used=n_used, min_count=min_count,
                            tile_rows=tile_rows, w=w, precision=precision)
    _require_cuda(packed)
    rows, w32, p, b, ys, th = _wgmma_inputs(packed, popcnt, y_padded, y_sum,
                                            thresh, precision)
    if tile_rows <= 0 or tile_rows % _cuda.TILE_ROWS or rows % tile_rows:
        raise ValueError(f"tile_rows ({tile_rows}) must be a multiple of "
                         f"{_cuda.TILE_ROWS} dividing the rows ({rows})")
    if not 1 <= w <= 1024:
        raise ValueError(f"w must be in [1, 1024], got {w}")
    dev = packed.device
    n_tiles = rows // _cuda.TILE_ROWS
    n_probe = rows // tile_rows
    tile_v = torch.empty((p, 3 * n_tiles), dtype=torch.float32, device=dev)
    tile_g = torch.empty((p, 3 * n_tiles), dtype=torch.int32, device=dev)
    tile_cnt = torch.empty((p, n_tiles), dtype=torch.int32, device=dev)
    merged = tile_rows > _cuda.TILE_ROWS
    mrg_v = torch.empty((p, 3 * n_probe) if merged else (0,),
                        dtype=torch.float32, device=dev)
    mrg_g = torch.empty_like(mrg_v, dtype=torch.int32)
    mrg_cnt = torch.empty((p, n_probe) if merged else (0,),
                          dtype=torch.int32, device=dev)
    out_v = torch.empty((2, p, w), dtype=torch.float32, device=dev)
    out_g = torch.empty((2, p, w), dtype=torch.int32, device=dev)
    out_ok = torch.empty((p,), dtype=torch.int32, device=dev)
    _count_select(n_probe, 2, w)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.lib.kgt_score_parity(
            packed.data_ptr(), popcnt.data_ptr(), b.data_ptr(),
            ys.data_ptr(), th.data_ptr(), rows, w32, p, *_chunk_args(b),
            float(n_used), float(min_count), tile_rows, w,
            tile_v.data_ptr(), tile_g.data_ptr(), tile_cnt.data_ptr(),
            mrg_v.data_ptr(), mrg_g.data_ptr(), mrg_cnt.data_ptr(),
            out_v.data_ptr(), out_g.data_ptr(), out_ok.data_ptr(),
            _fallback_counter(dev).data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "score_parity")
    score_batch_t_parity.launches += 1
    return out_v[0], out_g[0], out_v[1], out_g[1], out_ok.bool()


score_batch_t_parity.launches = 0


@span("score_batch_t_bmax")
def score_batch_t_bmax(packed, popcnt, y_padded, y_sum, *, n_used: int,
                       min_count: int, block: int = 16,
                       precision: str = "default"):
    """Exact-fallback kernel (csrc/score_plane.cu `kgt_score_bmax`, on the
    tensor-core body; replaces kmersgwas_tpu score_batch_t_pallas_bmax): ->
    (scores (P, R) f32, maxima of the contiguous `block`-lane blocks (P,
    R/block)). On the card block is 16 and the shapes those `_plane_inputs`
    takes; at the same P its scores equal score_batch_t_topw's values."""
    if packed.device.type == "cpu":
        return scores_and_bmax_plain(packed, popcnt, y_padded, y_sum,
                                     n_used=n_used, min_count=min_count,
                                     block=block, precision=precision)
    _require_cuda(packed)
    if block != 16:
        raise ValueError(f"the score_bmax kernel folds 16-lane blocks, "
                         f"got {block}")
    out = _plane_kernel(packed, popcnt, y_padded, y_sum, n_used=n_used,
                        min_count=min_count, precision=precision,
                        entry="kgt_score_bmax")
    score_batch_t_bmax.launches += 1
    return out


score_batch_t_bmax.launches = 0


@span("score_batch_t_tilemax")
def score_batch_t_tilemax(packed, popcnt, y_padded, y_sum, thresh, *,
                          n_used: int, min_count: int, tile_rows: int,
                          precision: str = "default"):
    """Compact scan kernel (csrc/score_tilemax.cu; replaces kmersgwas_tpu
    score_batch_t_pallas_tilemax): -> the nine (P, R/tile_rows) planes
    (tmax, targ, tmax2, targ2, tmax3, targ3, n2, n3, cnt) defined in
    tilemax_plain. On the card (tensor-core body, csrc/score_wgmma.cuh)
    tile_rows must be the kernel's TILE_ROWS, and the shapes those
    `_wgmma_inputs` takes."""
    if packed.device.type == "cpu":
        return tilemax_plain(packed, popcnt, y_padded, y_sum, thresh,
                             n_used=n_used, min_count=min_count,
                             tile_rows=tile_rows, precision=precision)
    _require_cuda(packed)
    if tile_rows != _cuda.TILE_ROWS:
        raise ValueError(f"the score_tilemax kernel reduces "
                         f"{_cuda.TILE_ROWS}-row tiles, got {tile_rows}")
    rows, w32, p, b, ys, th = _wgmma_inputs(packed, popcnt, y_padded, y_sum,
                                            thresh, precision)
    dev = packed.device
    n_tiles = rows // _cuda.TILE_ROWS
    planes = [torch.empty((p, n_tiles), dtype=dt, device=dev)
              for dt in (torch.float32, torch.int32) * 3
              + (torch.int32,) * 3]
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.lib.kgt_score_tilemax(
            packed.data_ptr(), popcnt.data_ptr(), b.data_ptr(),
            ys.data_ptr(), th.data_ptr(), rows, w32, p, *_chunk_args(b),
            float(n_used), float(min_count),
            *(t.data_ptr() for t in planes),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "score_tilemax")
    score_batch_t_tilemax.launches += 1
    return tuple(planes)


score_batch_t_tilemax.launches = 0
