"""Packed bit-plane <-> dense conversions (port of kmersgwas_tpu/ops/
bitplanes.py).

Planes are uint32 words, 32 samples per word, LSB-first. PyTorch cannot
shift uint32 on the CPU, so on the torch side planes travel as an int32
view of the same bits; `(x >> s) & 1` is still the bit s when the sign bit
is set (the shift is arithmetic, the mask drops the copies).
"""
from __future__ import annotations

import numpy as np
import torch


def as_planes(packed: np.ndarray) -> torch.Tensor:
    """(..., W) uint32 numpy planes -> int32 tensor view of the same bits."""
    return torch.from_numpy(
        np.ascontiguousarray(packed, dtype=np.uint32).view(np.int32))


def unpack_bits(packed: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """(..., W) int32 planes -> (..., W*32) 0/1 in `dtype`, LSB-first."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.to(dtype).reshape(*packed.shape[:-1], packed.shape[-1] * 32)


def unpack_bits_pm1(packed: torch.Tensor) -> torch.Tensor:
    """(..., W) int32 planes -> (..., W*32) int8 in {-1, +1} (bit b ->
    2b-1), LSB-first: the operand of the exact kinship Gram."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = ((packed[..., None] >> shifts) & 1).to(torch.int8)
    return (bits * 2 - 1).reshape(*packed.shape[:-1], packed.shape[-1] * 32)


def popcount_rows(packed: torch.Tensor) -> torch.Tensor:
    """Per-row popcount of int32 planes -> float32 (SWAR bit count on the
    words widened to int64, so the sign bit needs no special case)."""
    v = packed.to(torch.int64) & 0xFFFFFFFF
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    v = ((v * 0x01010101) & 0xFFFFFFFF) >> 24
    return v.sum(dim=-1).to(torch.float32)


def pack_bits_np(bits: np.ndarray) -> np.ndarray:
    """Host-side inverse for tests: (..., M) 0/1 -> (..., M/32) uint32."""
    assert bits.shape[-1] % 32 == 0
    by = np.packbits(bits.astype(np.uint8), axis=-1, bitorder="little")
    return np.ascontiguousarray(by).view("<u4").reshape(
        *bits.shape[:-1], bits.shape[-1] // 32)
