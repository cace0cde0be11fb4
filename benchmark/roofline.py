"""The card's peaks and the least time a piece of work needs on it.

Copies of the port's sound arithmetic at commit 6d84111: `CardPeaks` and
`CARD_PEAKS` of kmersgwas_tpu_torch/bench.py, `bound_ms` and the score and
Gram terms of chip_smoke.py `kernel_bounds`. Operations count what the
function needs at the cell's shapes, not what a kernel launches: the score
GEMM over the N used samples (not the padded lanes) and P columns, the
Gram's N (N + 1) / 2 entries on and above the diagonal. Bytes count each
input read once.
"""
from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class CardPeaks:
    """A card's dense peaks (NVIDIA's data sheet, at the full power limit):
    bf16 tensor-core FLOP/s, int8 tensor-core op/s and HBM bytes/s."""
    label: str
    bf16_flops: float
    int8_ops: float
    hbm_bytes: float


# by a substring of torch.cuda.get_device_name
CARD_PEAKS = (("H100 80GB HBM3",
               CardPeaks("NVIDIA H100 SXM", 989e12, 1979e12, 3.35e12)),)


def card_peaks(device_name: str) -> CardPeaks | None:
    """The peaks of the card named `device_name`, or None where unknown."""
    return next((pk for key, pk in CARD_PEAKS if key in device_name), None)


def bound_ms(n_bytes: float, ops: float, ops_per_s: float,
             bytes_per_s: float) -> tuple[float, str]:
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the HBM rate and the operations over their peak."""
    t_bytes = n_bytes / bytes_per_s * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_ops, "operations") if t_ops > t_bytes else (t_bytes, "bytes")


def score_bound_ms(peaks: CardPeaks, rows: int, n_used: int, p: int,
                   w32: int) -> tuple[float, str]:
    """The score work of `rows` rows: 2 rows N P bf16 FLOP (the (R, N) x
    (N, P) GEMM at precision "default"), against the rows' planes and
    popcounts read once."""
    return bound_ms(rows * (w32 * 4 + 4), 2.0 * rows * n_used * p,
                    peaks.bf16_flops, peaks.hbm_bytes)


def gram_bound_ms(peaks: CardPeaks, rows: int, n_used: int,
                  w32: int) -> tuple[float, str]:
    """The Gram work of `rows` rows: 2 rows N (N + 1) / 2 int8 operations,
    against the rows' planes read once."""
    return bound_ms(rows * w32 * 4, 2.0 * rows * n_used * (n_used + 1) / 2,
                    peaks.int8_ops, peaks.hbm_bytes)
