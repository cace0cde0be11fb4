"""Finds a cell's parts by name, so that a new configuration, traffic mix,
per-layer metric or probe is new files and new entries only:

  BENCHMARK.json                      the metrics and the cells
  <config's "file">                   a configuration's sizes
  benchmark/traffic/<mix>.json        a mix: its driver and parameters
  benchmark/drivers/<driver>.py       a general job driver (Cell)
  benchmark/limits/<workload>.json    the limit of each number compared
  benchmark/metrics/<metric>.py       a per-layer reader, read(record);
                                      where a name has none, the reader of
                                      the longest name it extends by
                                      ".<part>" (device_idle.scan_fresh
                                      reads with device_idle.py)
  benchmark/probes/<probe>.py         a traced run's extra measurement,
                                      run(cell)

Everything is looked up under `root`, the checkout's root.
"""
from __future__ import annotations

import importlib.util
import json
import os

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _by_name(items, name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _module(path: str, prefix: str):
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    name = prefix + os.path.basename(path)[:-3].replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench(root: str, *parts: str) -> str:
    return os.path.join(root, "benchmark", *parts)


def load_spec(root: str = ROOT) -> dict:
    return _json(os.path.join(root, "BENCHMARK.json"))


def workload(spec: dict, name: str) -> dict:
    return _by_name(spec["workloads"], name, "workload")


def config(spec: dict, root: str, name: str) -> dict:
    return _json(os.path.join(root, _by_name(spec["configs"], name,
                                             "config")["file"]))


def mix(root: str, name: str) -> dict:
    return _json(_bench(root, "traffic", name + ".json"))


def limits(root: str, workload_name: str) -> dict:
    return _json(_bench(root, "limits", workload_name + ".json"))


def driver(root: str, name: str):
    return _module(_bench(root, "drivers", name + ".py"), "bench_driver_")


def reader(root: str, metric: str):
    name = metric
    while not os.path.exists(_bench(root, "metrics", name + ".py")) \
            and "." in name:
        name = name.rsplit(".", 1)[0]
    return _module(_bench(root, "metrics", name + ".py"),
                   "bench_metric_").read


def probe(root: str, name: str):
    return _module(_bench(root, "probes", name + ".py"), "bench_probe_").run


def metrics_for(spec: dict, workload_name: str, kind: str) -> list:
    """The `kind` ("end_to_end" or "per_layer") metrics a cell reports:
    those that list it, and those that list no cells."""
    return [m for m in spec[kind]
            if workload_name in m.get("workloads", [workload_name])]
