"""Random packed bit-planes with fused popcounts: the generator of the
bench and of the at-scale stream (K6; replaces bench.py `_gen_kernel` /
`gen` (:320-351) and tools/at_scale_stream.py `_gen_kernel` / `gen`
(:64-87)).

Word j of row r of batch `step` is component j % 4 of
Philox4x32-10(counter = (r, j // 4, step mod 2^32, step >> 32),
key = (seed mod 2^32, seed >> 32)), so a batch is a pure function of
(seed, step, r, j): a resumed stream regenerates it byte for byte. The TPU
generator drew the TPU's hardware bits, which nothing else reproduces; the
port's bits are Philox's (Random123), not those.

Layout: the TPU generator wrote transposed (W32, R) planes, because its
scan kernel could take them as they were (`pre_transposed=True`,
kmersgwas_tpu/ops/scanstep.py:395-397) and skip a TPU relayout. The port's
score kernels read (R, W32) rows, so both versions here return (R, W32)
int32 rows (the int32 view of the uint32 words, ops/bitplanes.py) and an
(R,) f32 popcount over all W32 words, padding lanes included, as the TPU
generator's fused popcount.

`gen_planes` launches the gen_planes kernel (csrc/gen_planes.cu) for a
CUDA device and takes the plain version, `gen_planes_plain`, only for the
CPU; it counts its launches (`gen_planes.launches`).
"""
from __future__ import annotations

import torch

from . import _cuda
from .bitplanes import popcount_rows

PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit halves of m * x for a 32-bit constant m and int64 x
    in [0, 2^32). The full product overflows int64, so m is split into
    16-bit halves: both partial products stay below 2^48."""
    p_lo = x * (m & 0xFFFF)
    p_hi = x * (m >> 16)
    mid = p_lo + ((p_hi & 0xFFFF) << 16)
    return (p_hi >> 16) + (mid >> 32), mid & _MASK32


def philox4x32_10(c0, c1, c2, c3, k0: int, k1: int):
    """Philox4x32-10 of the counter (c0, c1, c2, c3), int64 tensors holding
    32-bit values, under the key (k0, k1): the four output words, int64
    tensors in [0, 2^32)."""
    for _ in range(10):
        hi0, lo0 = _mulhilo(PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo(PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0 = (k0 + PHILOX_W[0]) & _MASK32
        k1 = (k1 + PHILOX_W[1]) & _MASK32
    return c0, c1, c2, c3


def _check_args(w32: int, seed: int, step) -> None:
    if w32 <= 0 or w32 % 4:
        raise ValueError(f"w32 ({w32}) must be a positive multiple of 4")
    if not 0 <= seed < 1 << 64:
        raise ValueError(f"seed ({seed}) must be in [0, 2^64)")
    if isinstance(step, int) and not 0 <= step < 1 << 64:
        raise ValueError(f"step ({step}) must be in [0, 2^64)")


def gen_planes_plain(row_ids: torch.Tensor, w32: int, seed: int, step, *,
                     popcount: bool = True):
    """The plain version: rows `row_ids` ((n,) integer tensor, each in
    [0, 2^32)) of batch `step` (an int, or an (n,) int64 tensor giving each
    row's batch in [0, 2^63)) under `seed`, in torch int64 arithmetic on
    row_ids' device. -> ((n, W32) int32 planes, (n,) f32 popcounts), or the
    planes alone when popcount is False."""
    _check_args(w32, seed, step)
    r = row_ids.to(torch.int64)
    if r.numel() and (int(r.min()) < 0 or int(r.max()) > _MASK32):
        raise ValueError("row ids must be in [0, 2^32)")
    nb = w32 // 4
    shape = (r.shape[0], nb)
    if isinstance(step, int):
        s_lo, s_hi = step & _MASK32, step >> 32
    else:
        step = step.to(device=r.device, dtype=torch.int64)
        s_lo, s_hi = step & _MASK32, step >> 32
    c0 = r[:, None].expand(shape)
    c1 = torch.arange(nb, dtype=torch.int64, device=r.device)[None, :] \
        .expand(shape)
    c2, c3 = (torch.as_tensor(s, dtype=torch.int64, device=r.device)
              .reshape(-1, 1).expand(shape) for s in (s_lo, s_hi))
    words = torch.stack(philox4x32_10(c0, c1, c2, c3, seed & _MASK32,
                                      seed >> 32), dim=-1).reshape(-1, w32)
    planes = torch.where(words > 0x7FFFFFFF, words - (1 << 32),
                         words).to(torch.int32)
    return (planes, popcount_rows(planes)) if popcount else planes


def gen_planes(rows: int, w32: int, seed: int, step: int, device, *,
               popcount: bool = True):
    """Batch `step` of the stream under `seed`: ((rows, W32) int32 planes,
    (rows,) f32 popcounts) on `device`, or the planes alone when popcount
    is False (the kernel then writes no popcounts: the generators of the
    probes that count in a separate pass). A CUDA device launches the
    gen_planes kernel on the current stream (or raises); the CPU takes
    gen_planes_plain."""
    _check_args(w32, seed, step)
    if not 0 < rows <= 1 << 32:
        raise ValueError(f"rows ({rows}) must be in (0, 2^32]")
    dev = torch.device(device)
    if dev.type == "cpu":
        return gen_planes_plain(torch.arange(rows), w32, seed, step,
                                popcount=popcount)
    if dev.type != "cuda":
        raise ValueError(f"no gen_planes for device {device!r}: the CPU "
                         "takes the plain version, CUDA the kernel")
    planes = torch.empty((rows, w32), dtype=torch.int32, device=dev)
    pc = torch.empty(rows, dtype=torch.float32, device=dev) \
        if popcount else None
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.lib.kgt_gen_planes(
            planes.data_ptr(), pc.data_ptr() if popcount else None, rows,
            w32, seed, step, torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "gen_planes")
    gen_planes.launches += 1
    return (planes, pc) if popcount else planes


gen_planes.launches = 0
