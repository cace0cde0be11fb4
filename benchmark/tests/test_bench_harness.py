"""BENCHMARK.json against the benchmark's contract, and the harness finding
every part of a cell by name, also parts added in a copy without editing a
file."""
import json
import os
import re
import shutil

import pytest

from benchmark import harness

NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.\-]{1,16}")
SPEC = harness.load_spec()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_spec_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(json.dumps(SPEC)) <= 64 * 1024
    assert 1 <= len(SPEC["command"]) <= 32
    assert all(_line(w) for w in SPEC["command"])
    for p in SPEC["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and ".." not in p
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in SPEC[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)


def test_configs_and_cells():
    used = {w["config"] for w in SPEC["workloads"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(SPEC["paths"][0] + "/")
        cfg = harness.config(SPEC, harness.ROOT, c["name"])
        assert set(c["reduced"]) == set(cfg["reduced"])
        for key in c["reduced"]:
            assert NAME.fullmatch(key) and not key.endswith(("_dim", "_rank"))
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])


def test_metrics():
    cells = {w["name"] for w in SPEC["workloads"]}
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"]) and m["moves"] in e2e
        for w in m.get("workloads", cells):
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                             "higher")
    for w in cells:
        got = [m for m in SPEC["end_to_end"]
               if w in m.get("workloads", [w])]
        assert "setup_s" in [m["name"] for m in got] and len(got) >= 2
        assert harness.metrics_for(SPEC, w, "per_layer")


def test_every_part_is_found_by_name():
    root = harness.ROOT
    for w in SPEC["workloads"]:
        mix = harness.mix(root, w["traffic"])
        assert hasattr(harness.driver(root, mix["driver"]), "Cell")
        for p in mix.get("probes", []):
            assert callable(harness.probe(root, p))
        assert harness.limits(root, w["name"])
        harness.config(SPEC, root, w["config"])
    for m in SPEC["per_layer"]:
        assert callable(harness.reader(root, m["name"]))


def test_a_new_config_mix_and_metric_need_only_new_files(tmp_path):
    root = str(tmp_path)
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    os.path.join(root, "benchmark"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    b = os.path.join(root, "benchmark")
    with open(os.path.join(b, "configs", "athal1008.json")) as f:
        cfg = json.load(f)
    cfg["top_k"] = 1001
    with open(os.path.join(b, "configs", "extra.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(b, "traffic", "scan_fresh_short.json"), "w") as f:
        json.dump({"driver": "fresh_scan", "rate_metric": "scan_kmers_per_s",
                   "warm_batches": 2, "check_batches": 1,
                   "check_entries": 1}, f)
    with open(os.path.join(b, "limits", "extra.short.json"), "w") as f:
        json.dump({"score_gap": 0.01, "missed_gap": 0.01}, f)
    with open(os.path.join(b, "metrics", "extra.jobs.py"), "w") as f:
        f.write("def read(record):\n    return 7.0\n")
    spec = harness.load_spec(root)
    spec["configs"].append({"name": "extra", "source": "x",
                            "file": "benchmark/configs/extra.json",
                            "reduced": ["table_rows"], "why": "x"})
    spec["workloads"].append({"name": "extra.short", "config": "extra",
                              "traffic": "scan_fresh_short", "chips": 1,
                              "why": "x"})
    spec["per_layer"].append({"name": "extra.jobs", "unit": "jobs",
                              "better": "higher", "source": "host_clock",
                              "layer": "driver", "moves": "setup_s"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    spec = harness.load_spec(root)
    w = harness.workload(spec, "extra.short")
    assert harness.config(spec, root, w["config"])["top_k"] == 1001
    mix = harness.mix(root, w["traffic"])
    assert hasattr(harness.driver(root, mix["driver"]), "Cell")
    assert harness.limits(root, "extra.short")["score_gap"] == 0.01
    assert "extra.jobs" in [m["name"] for m in
                            harness.metrics_for(spec, "extra.short",
                                                "per_layer")]
    assert harness.reader(root, "extra.jobs")({}) == 7.0
    # a name without a file of its own reads with the name it extends
    assert (harness.reader(root, "extra.jobs.more")
            .__module__ == "bench_metric_extra_jobs")
    assert (harness.reader(root, "device_idle.extra")
            .__module__ == "bench_metric_device_idle")
    with pytest.raises(FileNotFoundError):
        harness.reader(root, "absent.metric")
    with pytest.raises(KeyError):
        harness.workload(spec, "absent")
