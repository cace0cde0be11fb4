"""kmersgwas_tpu_torch: the k-mer GWAS association scan in PyTorch + CUDA.

A port of kmersgwas_tpu (JAX/Pallas on TPU) to PyTorch with hand-written
CUDA kernels for NVIDIA Hopper (sm_90a). The JAX package stays the
reference; this package never imports jax. Its layout and names follow the
JAX package's, so each module's counterpart is easy to find.

Importing the package needs neither a GPU nor nvcc: the kernels are built
from csrc/ at first use (ops/_cuda.py).
"""
__version__ = "0.1.0"

__all__ = ["associate"]


def __getattr__(name):
    # lazy top-level API, as in kmersgwas_tpu/__init__.py
    if name == "associate":
        from .pipeline.scan import associate
        return associate
    raise AttributeError(name)
