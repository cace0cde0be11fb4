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
        "import kmersgwas_tpu_torch.pipeline.kinship\n"
        "import kmersgwas_tpu_torch.pipeline.gwas\n"
        "import kmersgwas_tpu_torch.pipeline.align\n"
        "import kmersgwas_tpu_torch.stats.emma\n"
        "import kmersgwas_tpu_torch.stats.mvnpermute\n"
        "import kmersgwas_tpu_torch.stats.transform\n"
        "import kmersgwas_tpu_torch.stats.lmm\n"
        "import kmersgwas_tpu_torch.stats.gamma\n"
        "import kmersgwas_tpu_torch.snps.bed, kmersgwas_tpu_torch.snps.assoc\n"
        "import kmersgwas_tpu_torch.snps.kinship\n"
        "import kmersgwas_tpu_torch.pipeline.snp_gwas\n"
        "import kmersgwas_tpu_torch.ops.kinship\n"
        "import kmersgwas_tpu_torch.ops.scanstep\n"
        "import kmersgwas_tpu_torch.parallel.multihost\n"
        "import kmersgwas_tpu_torch.parallel.sharding\n"
        "import kmersgwas_tpu_torch.cli.__main__\n"
        "import kmersgwas_tpu_torch.bench, kmersgwas_tpu_torch.ops.gen\n"
        "import kmersgwas_tpu_torch.tools.at_scale_stream\n"
        "import kmersgwas_tpu_torch.tools.probes\n"
        "import kmersgwas_tpu_torch.tools.exp_kernel\n"
        "import kmersgwas_tpu_torch.tools.prof_step\n"
        "import kmersgwas_tpu_torch.tools.prof_r5_certify\n"
        "import kmersgwas_tpu_torch.tools.prof_r5_feedgap\n"
        "import kmersgwas_tpu_torch.tools.bench_ingest\n"
        "import kmersgwas_tpu_torch.tools.at_scale_run\n"
        "import kmersgwas_tpu_torch.ops.tilereduce\n"
        "import kmersgwas_tpu_torch.native\n"
        "import kmersgwas_tpu_torch.ingest.streamio\n"
        "import kmersgwas_tpu_torch.ingest.counter\n"
        "import kmersgwas_tpu_torch.ingest.strand\n"
        "import kmersgwas_tpu_torch.ingest.union\n"
        "import kmersgwas_tpu_torch.ingest.tablebuild\n"
        "import kmersgwas_tpu_torch.ingest.kmc\n"
        "import kmersgwas_tpu_torch.pipeline.export\n"
        "import kmersgwas_tpu_torch.examples.simulated_ecoli_like\n"
        "from kmersgwas_tpu_torch.ops import _cuda\n"
        "assert 'jax' not in sys.modules, 'jax imported'\n"
        "assert not [m for m in sys.modules if m == 'kmersgwas_tpu'\n"
        "            or m.startswith('kmersgwas_tpu.')], 'JAX package imported'\n"
        "assert _cuda.library.cache_info().currsize == 0, 'library loaded'\n"
        "assert kmersgwas_tpu_torch.native.load.cache_info().currsize == 0\n"
        "assert kmersgwas_tpu_torch.native.load_ingest.cache_info()"
        ".currsize == 0\n"
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
                top = name.split(".")[0]
                assert top != "jax", f"{path}: imports {name}"
                # the port keeps its own copies: nothing of the JAX package
                assert top != "kmersgwas_tpu", f"{path}: imports {name}"


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
