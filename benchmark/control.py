"""The control of each cell's check: the plain reference put in the
program's place, at the precision below the configuration's, judged by the
same comparison. It has to come out not correct.

    python3 -m benchmark.control --workload <name> --seeds <n> [<n> ...]

One JSON line a seed: the numbers compared and their limits. The scan cells'
control scores with the phenotypes rounded to float8 e4m3 (the configuration
states bfloat16); the kinship cells' normalizes the exact counts in float32
(the configuration states float64). The inputs are the run's of the same
seed, at the cell's own size; the benchmark's runs never run this.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from benchmark import harness, inputs
from benchmark.drivers import Context


def main(argv=None, *, root: str = harness.ROOT, device=None) -> list:
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    import torch
    spec = harness.load_spec(root)
    wl = harness.workload(spec, args.workload)
    cfg = harness.config(spec, root, wl["config"])
    mix = harness.mix(root, wl["traffic"])
    limits = harness.limits(root, wl["name"])
    dev = torch.device(device or "cuda:0")
    out = []
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = Context(cfg=cfg, mix=mix, seed=seed, device=dev,
                      workdir=os.path.join(root, "benchmark", "build",
                                           "data", wl["name"]))
        cell = harness.driver(root, mix["driver"]).Cell(ctx)
        cell.setup(warm=False)
        numbers = cell.control(np.random.default_rng(
            inputs.subseed(seed, "check")))
        line = {"workload": wl["name"], "seed": seed,
                "numbers": numbers, "limits": limits,
                "fails": any(numbers[k] > limits[k] for k in limits),
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line, default=str), flush=True)
        out.append(line)
        del cell
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


if __name__ == "__main__":
    main()
