"""The import guard: no run of the benchmark loads JAX or the JAX package
(top-level module names compared whole, so kmersgwas_tpu_torch passes and
kmersgwas_tpu does not), and the reference loads nothing of the port."""
import ast
import json
import os
import subprocess
import sys
import time
import types

import pytest

from benchmark import harness, run
from benchmark.tests.tiny import tiny_root

REF = os.path.join(harness.ROOT, "benchmark", "reference")
RUN_ALL = """
import json, sys, tempfile, time
from benchmark.tests.tiny import tiny_root
from benchmark import harness, run
root = tiny_root(tempfile.mkdtemp())
for w in harness.load_spec()["workloads"]:
    for tr in ("0", "1"):
        rc = run.main(["--workload", w["name"], "--seed", "2147483999",
                       "--seconds", "0.05", "--trace", tr], root=root,
                      device="cpu", t0=time.perf_counter())
        assert rc == 0, (w["name"], tr, rc)
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         capture_output=True, text=True, timeout=900,
                         check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_runs_of_every_cell_load_no_jax_and_no_jax_package():
    mods = _modules_after(RUN_ALL)
    assert "kmersgwas_tpu_torch" in mods
    assert not mods & set(run.FORBIDDEN), mods & set(run.FORBIDDEN)


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "kmersgwas_tpu_torch.fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "kmersgwas_tpu.fake", object())
    monkeypatch.setitem(sys.modules, "jaxlib_not", object())
    assert run.forbidden_modules() == ["kmersgwas_tpu"]


@pytest.mark.parametrize("stage", ["check", "reader"])
def test_a_module_loaded_after_the_window_withholds_the_result(
        stage, tmp_path, capsys, monkeypatch):
    """A forbidden module that the check or a per-layer reader loads, after
    the window has closed, still leaves the run without a result."""
    def load():
        monkeypatch.setitem(sys.modules, "flax", types.ModuleType("flax"))
    if stage == "check":
        driver = harness.driver

        def loading_driver(root, name):
            base = driver(root, name).Cell

            class Cell(base):
                def check(self, rng):
                    load()
                    return base.check(self, rng)
            return types.SimpleNamespace(Cell=Cell)
        monkeypatch.setattr(harness, "driver", loading_driver)
    else:
        reader = harness.reader

        def loading_reader(root, metric):
            read = reader(root, metric)

            def r(record):
                load()
                return read(record)
            return r
        monkeypatch.setattr(harness, "reader", loading_reader)
    root = tiny_root(str(tmp_path))
    rc = run.main(["--workload", "athal1008.kinship_fresh", "--seed",
                   "2147483999", "--seconds", "0.05", "--trace", "1"],
                  root=root, device="cpu", t0=time.perf_counter())
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert out.err.strip().splitlines()[-1] == "loaded after the window: flax"


def test_the_reference_imports_nothing_of_the_port():
    names = [f[:-3] for f in os.listdir(REF) if f.endswith(".py")]
    for n in names:
        with open(os.path.join(REF, n + ".py")) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = [a.name.split(".")[0] for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                tops = [(node.module or "").split(".")[0]]
            else:
                continue
            assert not set(tops) & {"kmersgwas_tpu_torch", *run.FORBIDDEN}
    code = ("import json, sys\n"
            + "".join(f"import benchmark.reference.{n}\n" for n in names)
            + "print(json.dumps(sorted({m.split('.')[0] "
              "for m in sys.modules})))")
    mods = _modules_after(code)
    assert not mods & {"kmersgwas_tpu_torch", *run.FORBIDDEN}
