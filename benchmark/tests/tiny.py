"""A copy of the benchmark at CPU sizes, for the tests: the same files, the
configurations and mixes cut down so a whole run takes seconds."""
from __future__ import annotations

import json
import os
import shutil

from benchmark import harness

TINY = {
    "athal1008": dict(n_accessions=100, phenotypes=5, top_k=40,
                      kmers=6144, scan_batch_rows=1024,
                      kinship_batch_rows=512, table_rows=5000),
    "ecoli241": dict(n_accessions=40, phenotypes=5, top_k=40,
                     scan_batch_rows=1024, kinship_batch_rows=512,
                     table_rows=5000),
}
TINY_MIX = {"warm_batches": 3, "check_batches": 2, "check_entries": 3}


def tiny_root(dst: str) -> str:
    """Copy BENCHMARK.json and benchmark/ (without build/) under dst, with
    the configurations and mixes at CPU sizes; returns dst."""
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), dst)
    shutil.copytree(os.path.join(harness.ROOT, "benchmark"),
                    os.path.join(dst, "benchmark"),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    for name, sizes in TINY.items():
        path = os.path.join(dst, "benchmark", "configs", name + ".json")
        with open(path) as f:
            cfg = json.load(f)
        cfg.update(sizes)
        with open(path, "w") as f:
            json.dump(cfg, f)
    tdir = os.path.join(dst, "benchmark", "traffic")
    for fn in os.listdir(tdir):
        with open(os.path.join(tdir, fn)) as f:
            mix = json.load(f)
        mix.update({k: v for k, v in TINY_MIX.items() if k in mix})
        with open(os.path.join(tdir, fn), "w") as f:
            json.dump(mix, f)
    return dst
