"""The benchmark of kmersgwas_tpu_torch: see benchmark/run.py and BENCHMARK.json."""
