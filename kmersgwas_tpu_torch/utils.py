"""Small shared utilities: device checks, stage timing, bounded dispatch.

Port of kmersgwas_tpu/utils.py. `drain` waits on a CUDA event recorded
after a step instead of fetching a host scalar.
"""
from __future__ import annotations

import sys
import time

import torch


def require_device(device) -> torch.device:
    """torch.device for `device`; raises for "cuda" without a usable card.
    There is no silent CPU path: a run asked to use the card uses it or
    fails."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def step_event(device: torch.device):
    """A CUDA event recorded on the current stream after a step's work, or
    None on the CPU (where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


def drain(event) -> None:
    """Backpressure point of the bounded dispatch pipeline: wait until the
    device has completed the step that recorded `event` (a few batches
    back), so no more than a fixed number of batches' inputs stay alive.
    `event` may be a list (one event per device of a mesh)."""
    for ev in event if isinstance(event, list) else (event,):
        if ev is not None:
            ev.synchronize()


class StageTimer:
    """Accumulates per-stage wall time + item counts; prints to stderr."""

    def __init__(self, name: str, unit: str = "items", quiet: bool = False):
        self.name = name
        self.unit = unit
        self.quiet = quiet
        self.t0 = time.perf_counter()
        self.items = 0
        self._last_report = self.t0

    def add(self, n: int) -> None:
        self.items += n
        now = time.perf_counter()
        if not self.quiet and now - self._last_report > 10.0:
            self._last_report = now
            rate = self.items / max(now - self.t0, 1e-9)
            print(f"[{self.name}] {self.items:,} {self.unit} "
                  f"({rate:,.0f}/s)", file=sys.stderr, flush=True)

    def done(self) -> float:
        dt = time.perf_counter() - self.t0
        if not self.quiet:
            rate = self.items / max(dt, 1e-9)
            print(f"[{self.name}] done: {self.items:,} {self.unit} in "
                  f"{dt:.1f}s ({rate:,.0f}/s)", file=sys.stderr, flush=True)
        return dt
