"""The numbers that decide `correct`, each compared with its limit.

Scan cells (each column's reported top-k, against float64 scores of the
same rows worked out by benchmark/reference/scan.py):
  score_gap  - the widest gap between a reported score and the float64
               score of its row, over the column's largest float64 score;
               a reported entry that is not finite, or whose fetched k-mer
               code or presence row differs from the table's, reads inf,
               and so does a column that reports one row twice (the copy
               would push a true entry out unseen).
  missed_gap - how far the best row left out of a column lies above the
               lowest float64 score the column reported, over the same
               scale (0 where no row left out lies above it).
Kinship cells:
  kinship_gap - the widest entry gap between the reported matrix and the
               reference's (an exact comparison: the limit is 0).
"""
from __future__ import annotations

import numpy as np
import torch


def repeats(ids: np.ndarray) -> bool:
    """Whether any row of (P, K) row ids names one row twice."""
    s = np.sort(np.asarray(ids), axis=1)
    return bool((s[:, 1:] == s[:, :-1]).any())


def score_gap(reported: np.ndarray, exact: np.ndarray, ids: np.ndarray,
              valid: np.ndarray | None = None) -> tuple[float, np.ndarray]:
    """(gap, per-column scale) of (P, K) reported scores against the (P, K)
    float64 scores of their rows `ids`; `valid` (P, K) bool marks entries
    whose fetched row matched the table."""
    reported = np.asarray(reported, np.float64)
    scale = np.maximum(np.max(exact, axis=1), np.finfo(np.float64).tiny)
    if not np.isfinite(reported).all() or repeats(ids) or (
            valid is not None and not valid.all()):
        return float("inf"), scale
    return float(np.max(np.abs(reported - exact) / scale[:, None])), scale


def best_left_out(s64: torch.Tensor, ids: torch.Tensor,
                  reported_ids: torch.Tensor,
                  floor: torch.Tensor) -> torch.Tensor:
    """Per column, the highest float64 score among rows `ids` (with (R, P)
    scores s64) above floor[c] that column c did not report; -inf where
    there is none. reported_ids (P, K) int64, floor (P,) float64."""
    out = torch.full((s64.shape[1],), float("-inf"), dtype=torch.float64,
                     device=s64.device)
    hot = s64 > floor[None, :]
    for c in torch.nonzero(hot.any(dim=0)).flatten().tolist():
        rows = torch.nonzero(hot[:, c]).flatten()
        left = ~torch.isin(ids[rows], reported_ids[c])
        if left.any():
            out[c] = s64[rows[left], c].max()
    return out


def missed_gap(best_left: np.ndarray, exact: np.ndarray,
               scale: np.ndarray) -> float:
    """max over columns of (best row left out - lowest reported float64
    score) / scale, and 0 where no row left out lies above it."""
    lowest = np.min(exact, axis=1)
    return float(max(0.0, np.max((best_left - lowest) / scale)))


def kinship_gap(reported: np.ndarray, exact: np.ndarray) -> float:
    if reported.shape != exact.shape or not np.isfinite(reported).all():
        return float("inf")
    return float(np.max(np.abs(reported - exact)))
