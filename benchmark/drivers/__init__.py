"""The general job drivers. A traffic mix (benchmark/traffic/<mix>.json)
names one of these modules under "driver" and gives its parameters; a
configuration (benchmark/configs/<config>.json) gives the sizes. Each module
holds a `Cell(ctx)` with:

  rate_metric       the end-to-end metric its jobs' rows make
  setup()           inputs made from the seed, every shape warmed
  job(i) -> rows    one whole job, its result taken to the host
  traced_job(i)     job(i) with the benchmark's spans around the program's
                    layer calls (the traced run's extra job)
  record() -> dict  what the per-layer readers read: "counters", "spans"
                    (lists of seconds), "work" (the cell's shapes)
  free()            drop the program's state once the window has closed
  check(rng) -> {number: value}      the comparison with the reference
  control(rng) -> {number: value}    the same comparison, the reference
                    in the program's place at the precision below
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch


@dataclass
class Context:
    cfg: dict                  # the configuration's file
    mix: dict                  # the traffic mix's file
    seed: int
    device: torch.device
    workdir: str               # a fixed directory of this cell's data
    record: dict = field(default_factory=lambda: {
        "counters": {}, "spans": {}, "work": {}})

    def count(self, key: str, n: int = 1) -> None:
        c = self.record["counters"]
        c[key] = c.get(key, 0) + n

    def span(self, key: str, seconds: float) -> None:
        self.record["spans"].setdefault(key, []).append(seconds)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
