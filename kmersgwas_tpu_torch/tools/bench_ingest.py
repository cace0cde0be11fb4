"""Out-of-core ingest benchmark: the union and the table build alone, under
bounded memory (port of tools/bench_ingest.py).

    python -m kmersgwas_tpu_torch.tools.bench_ingest [--rows 120e6]
        [--samples 32] [--route native|numpy] [--workdir DIR]

Writes `--samples` sorted strand lists (k = 31) slice by slice over the
k-mer space (each pool k-mer in a sample with probability 0.35, a random
strand flag; bounded memory), then runs `list-kmers`' union (MAC 2,
min strand share 0.2) and `build-table` in a SUBPROCESS, through the
native ingest library (native/kgt_ingest.cpp) or the numpy route
(ingest/union.py, ingest/tablebuild.py), and prints one JSON line from
it: {"route", "n_samples", "master_rows", "table_rows", "union_s",
"table_s", "peak_rss_gb", "union_krows_per_s", "table_krows_per_s"} (the
JAX tool's fields; the peak RSS is the subprocess's, so it excludes the
generation). Host code only: no device is used. The lists are reused
when `--workdir` already holds them.
"""
from __future__ import annotations

import argparse
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

import numpy as np

K = 31
N_GEN_SLICES = 64
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def generate(workdir: str, target_rows: int, n_samples: int, seed: int = 0):
    """Write the per-sample strand lists slice by slice -> their paths."""
    rng = np.random.default_rng(seed)
    space = 1 << (2 * K)
    per_slice = max(target_rows // N_GEN_SLICES, 1)
    paths = [os.path.join(workdir, f"s{i}.kmers") for i in range(n_samples)]
    files = [open(p, "wb") for p in paths]
    t0 = time.perf_counter()
    total = 0
    try:
        for s in range(N_GEN_SLICES):
            lo = s * (space // N_GEN_SLICES)
            pool = np.unique(rng.integers(lo, lo + space // N_GEN_SLICES,
                                          size=int(per_slice * 1.05),
                                          dtype=np.uint64))
            total += len(pool)
            for f in files:
                kk = pool[rng.random(len(pool)) < 0.35]
                ff = rng.integers(1, 4, size=len(kk)).astype(np.uint64)
                (kk | (ff << np.uint64(62))).astype("<u8").tofile(f)
    finally:
        for f in files:
            f.close()
    print(f"[gen] {total:,} pool k-mers x {n_samples} samples in "
          f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
    return paths


def child(route: str, workdir: str, n_samples: int) -> dict:
    """The measured phase (run in its own process by main)."""
    paths = [os.path.join(workdir, f"s{i}.kmers") for i in range(n_samples)]
    names = [f"acc{i}" for i in range(n_samples)]
    master = os.path.join(workdir, "master.bin")
    base = os.path.join(workdir, "pop")
    t0 = time.perf_counter()
    if route == "native":
        from .. import native
        n_pass = native.list_union(paths, K, 2, 0.2, master,
                                   write_stats=False)
        t1 = time.perf_counter()
        n_rows = native.build_table(paths, names, master, base, K)
    else:
        from ..ingest import tablebuild, union
        n_pass, _ = union.build_master_list(paths, master, K, mac=2,
                                            min_strand_frac=0.2,
                                            collect_stats=False)
        t1 = time.perf_counter()
        n_rows = tablebuild.build_table(paths, names, master, base, K)
    t2 = time.perf_counter()
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6
    return {"route": route, "n_samples": n_samples, "master_rows": n_pass,
            "table_rows": n_rows, "union_s": t1 - t0, "table_s": t2 - t1,
            "peak_rss_gb": rss_gb,
            "union_krows_per_s": n_pass / max(t1 - t0, 1e-9) / 1e3,
            "table_krows_per_s": n_rows / max(t2 - t1, 1e-9) / 1e3}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m kmersgwas_tpu_torch.tools.bench_ingest",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=float, default=120e6)
    ap.add_argument("--samples", type=int, default=32)
    ap.add_argument("--route", choices=["native", "numpy"], default="native")
    ap.add_argument("--workdir", default=None)
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        print(json.dumps(child(a.route, a.workdir, a.samples)), flush=True)
        return
    workdir = a.workdir or tempfile.mkdtemp(prefix="kgt_ingest_bench_")
    os.makedirs(workdir, exist_ok=True)
    if not os.path.exists(os.path.join(workdir, f"s{a.samples - 1}.kmers")):
        generate(workdir, int(a.rows), a.samples)
    # the measured phase runs in a subprocess: its peak RSS excludes the
    # generation
    subprocess.run([sys.executable, "-m",
                    "kmersgwas_tpu_torch.tools.bench_ingest", "--child",
                    "--route", a.route, "--workdir", workdir, "--samples",
                    str(a.samples)], check=True, cwd=ROOT)


if __name__ == "__main__":
    main()
