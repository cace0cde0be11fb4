"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s>
                             --trace <0|1>

Loads, makes the inputs from the seed and warms up (set-up, `setup_s`),
runs whole jobs back to back for at least `--seconds` (benchmark/window.py),
then checks what the jobs produced against the plain reference. With
`--trace 1` it also runs one more job under the profiler, runs the mix's
probes, and reports the per-layer metrics instead of the end-to-end ones.
The last line of standard output is the result, one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error and the result's last key.

It measures kmersgwas_tpu_torch only, and fails without a result when no
CUDA card is available, or when the JAX package or JAX is loaded once the
window has closed.
"""
from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402

from benchmark import harness, inputs, trace, window  # noqa: E402
from benchmark.drivers import Context  # noqa: E402
from benchmark.roofline import card_peaks  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "kmersgwas_tpu")


def forbidden_modules() -> list:
    """Forbidden top-level names among the loaded modules, compared whole:
    kmersgwas_tpu_torch is not kmersgwas_tpu."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _num(v: float):
    """A JSON number, or a string where it is not finite."""
    return v if math.isfinite(v) else str(v)


def _card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
        return out.stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "nvidia-smi: not read"


def _spread(win) -> str:
    t = sorted(e - s for s, e, _ in win.jobs)
    return f"{t[0]:.4f}/{t[len(t) // 2]:.4f}/{t[-1]:.4f}"


def parse(argv=None):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, *, root: str = harness.ROOT, device=None,
         t0: float | None = None) -> int:
    """Run the cell; returns the exit code. `device` None means the card,
    and a run fails without one; tests pass "cpu" to drive the rest."""
    t0 = _T0 if t0 is None else t0
    args = parse(argv)
    if not 0 <= args.seed < 1 << 63:
        raise SystemExit(f"--seed {args.seed} out of range")
    spec = harness.load_spec(root)
    wl = harness.workload(spec, args.workload)
    cfg = harness.config(spec, root, wl["config"])
    mix = harness.mix(root, wl["traffic"])
    limits = harness.limits(root, wl["name"])

    import torch
    if device is None:
        if not torch.cuda.is_available() \
                or torch.cuda.device_count() < wl["chips"]:
            print(f"{wl['name']} needs {wl['chips']} CUDA card(s); "
                  f"available: {torch.cuda.is_available()}, count: "
                  f"{torch.cuda.device_count()}", file=sys.stderr)
            return 2
        device = "cuda:0"
    dev = torch.device(device)
    on_card = dev.type == "cuda"

    ctx = Context(cfg=cfg, mix=mix, seed=args.seed, device=dev,
                  workdir=os.path.join(root, "benchmark", "build", "data",
                                       wl["name"]))
    cell = harness.driver(root, mix["driver"]).Cell(ctx)
    cell.setup()
    setup_s = time.perf_counter() - t0

    win = window.run_window(cell.job, args.seconds)
    record = cell.record()
    summary = None
    if args.trace:
        _, summary = trace.traced_job(cell.traced_job, len(win.jobs))
        record["probes"] = {name: harness.probe(root, name)(cell)
                            for name in mix.get("probes", [])}
        record["trace"] = summary
        record["peaks"] = (card_peaks(torch.cuda.get_device_name(dev))
                           if on_card else None)
    peak = torch.cuda.max_memory_allocated(dev) if on_card else 0

    cell.free()
    t_check = time.perf_counter()
    numbers = cell.check(np.random.default_rng(
        inputs.subseed(args.seed, "check")))
    check_s = time.perf_counter() - t_check
    checks = {k: {"value": _num(numbers[k]), "limit": limits[k]}
              for k in limits}
    correct = (set(numbers) == set(limits)
               and all(numbers[k] <= limits[k] for k in limits))

    if args.trace:
        metrics = {}
        for m in harness.metrics_for(spec, wl["name"], "per_layer"):
            v = harness.reader(root, m["name"])(record)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        units = {m["name"]: m["unit"] for m in spec["end_to_end"]}
        metrics = {cell.rate_metric: {"value": win.rate,
                                      "unit": units[cell.rate_metric]},
                   "setup_s": {"value": setup_s, "unit": units["setup_s"]}}
    dev_info = {"platform": "gpu" if on_card else dev.type,
                "kind": (torch.cuda.get_device_name(dev) if on_card
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(peak)}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
    result = {"correct": bool(correct), "attempted": len(win.jobs),
              "failed": 0 if correct else 1, "metrics": metrics,
              "device": dev_info}
    if summary is not None:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks

    print("job s: " + " ".join(f"{e - s:.3f}" for s, e, _ in win.jobs),
          file=sys.stderr)
    if summary is not None:
        print("traced job's host spans, s: " + json.dumps(summary.host_s),
              file=sys.stderr)
    print(f"{wl['name']} seed {args.seed}: {len(win.jobs)} jobs, "
          f"{win.rows} rows in {win.seconds:.3f} s, set-up {setup_s:.3f} s, "
          f"check {check_s:.3f} s, job s {_spread(win)}; "
          f"{_card_line() if on_card else 'cpu'}",
          file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    # Last, so that it covers the window, the trace, the probes, the check
    # and the readers: a module once loaded stays in sys.modules.
    bad = forbidden_modules()
    if bad:
        print(f"loaded after the window: {', '.join(bad)}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
