"""The plain reference the benchmark's outputs are judged against: the
association score, the exact Gram and the kinship's normalization, and a
writer and reader of the k-mers `.table` format, in plain PyTorch and NumPy.

It imports nothing of the port (kmersgwas_tpu_torch) nor of the JAX package
(benchmark/tests/test_bench_imports.py holds it to that), and takes nothing
the port made: it is handed the benchmark's own inputs (generated planes,
the `.table` it wrote, the phenotypes) and works out the rest again.
"""
