"""The port never imports jax and builds nothing at import.

tests/conftest.py imports jax into this process, so the import check runs
in a fresh interpreter."""
import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "kmersgwas_tpu_torch"


def test_port_imports_without_jax_or_a_build():
    code = (
        "import sys\n"
        "import kmersgwas_tpu_torch, kmersgwas_tpu_torch.convert\n"
        "import kmersgwas_tpu_torch.pipeline.scan\n"
        "import kmersgwas_tpu_torch.cli.__main__\n"
        "from kmersgwas_tpu_torch.ops import _cuda\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert _cuda.library.cache_info().currsize == 0, 'library loaded'\n"
        "print('ok')\n")
    env = dict(os.environ, PATH="/usr/bin:/bin")      # no nvcc on PATH
    env.pop("PYTHONPATH", None)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_sources_never_import_jax():
    files = sorted(f for f in PKG.rglob("*.py")      # build/ is output
                   if "build" not in f.relative_to(PKG).parts)
    smoke = ROOT / "chip_smoke.py"
    files.append(smoke)
    assert len(files) > 10
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import)
                     else [node.module or ""]
                     if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] != "jax", f"{path}: imports {name}"
                # the smoke writes its own inputs: nothing of the JAX package
                assert path != smoke or name.split(".")[0] != "kmersgwas_tpu", \
                    f"{path}: imports {name}"
                if name.startswith("kmersgwas_tpu."):
                    # only the jax-free modules of the JAX package
                    assert name in ("kmersgwas_tpu.core", "kmersgwas_tpu.core.table",
                                    "kmersgwas_tpu.core.formats",
                                    "kmersgwas_tpu.core.codec",
                                    "kmersgwas_tpu.native",
                                    "kmersgwas_tpu"), f"{path}: {name}"


def test_build_without_nvcc_raises(monkeypatch):
    from kmersgwas_tpu_torch.ops import _cuda
    monkeypatch.setattr(_cuda.shutil, "which", lambda _name: None)
    monkeypatch.setattr(_cuda, "NVCC_CANDIDATES", ())
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.library.__wrapped__()


def test_require_device(monkeypatch):
    from kmersgwas_tpu_torch.utils import require_device
    assert require_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        require_device("meta")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        require_device("cuda")
