"""Default-precision top-k selection against a "highest" oracle, and the
certify_topk certificate, at a realistic shape (port of
tools/prof_r5_certify.py).

    python -m kmersgwas_tpu_torch.tools.prof_r5_certify [n_seeds]
        [--rows R] [--p P] [--k K] [--batch_size B] [--device cuda|cpu]
        [--workdir DIR]

The bench's synthetic population (bench._synthetic_pop: R rows, default
8,000,000, of N=1008 accessions, with its .dtable) is scanned end to end
through pipeline.scan.associate (batches of B rows, default 2,000,000)
three ways per seed, with top-K (default 10001) over P (default 101)
normal columns drawn from the seed:
score_precision "default", "highest" (the oracle) and "default" with
certify_topk. Per column it counts
  swaps: |oracle set \\ selected set| (rows the oracle keeps that the
         other selection missed; symmetric, as both sets hold K rows),
and the certified columns. One JSON line per seed on stdout: {"seed",
"selections", "swaps_default", "swap_rate_default",
"max_swaps_per_column", "columns_with_swaps", "swaps_certified",
"certified", "columns", "wall_default_s", "wall_highest_s",
"wall_certify_s", "rows", "device", "card"}.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np

from .. import bench
from ..pipeline import scan as scan_mod
from ..utils import require_device


def main(n_seeds: int = 2, n_rows: int = 8_000_000, p: int = 101,
         k: int = 10001, device="cuda", workdir: str = bench.WORKDIR,
         batch_size: int = 2_000_000) -> list:
    dev = require_device(device)
    card = bench.card_line(dev)
    base, dtable, names, n, kmer_len = bench._synthetic_pop(n_rows, workdir)
    cols = [f"c{j}" for j in range(p)]
    out = []
    for seed in range(1, n_seeds + 1):
        y = np.random.default_rng(seed).normal(size=(n, p))
        kw = dict(kmer_len=kmer_len, n_top=k, maf=0.05, mac=5,
                  batch_size=batch_size, dtable_cache=dtable, device=dev,
                  progress=lambda r: None)
        runs, walls = {}, {}
        for name, extra in (("default", {}),
                            ("highest", dict(score_precision="highest")),
                            ("certify", dict(certify_topk=True))):
            t0 = time.perf_counter()
            runs[name] = scan_mod.associate(base, names, y, cols, **kw,
                                            **extra)
            walls[name] = time.perf_counter() - t0
        oracle = [set(r.tolist()) for r in runs["highest"].rows]
        swaps = {name: np.array([len(o - set(r.tolist())) for o, r in
                                 zip(oracle, runs[name].rows)])
                 for name in ("default", "certify")}
        line = {"seed": seed, "selections": p * k,
                "swaps_default": int(swaps["default"].sum()),
                "swap_rate_default": float(swaps["default"].sum() / (p * k)),
                "max_swaps_per_column": int(swaps["default"].max()),
                "columns_with_swaps": int((swaps["default"] > 0).sum()),
                "swaps_certified": int(swaps["certify"].sum()),
                "certified": int(sum(runs["certify"].certified)),
                "columns": p,
                "wall_default_s": walls["default"],
                "wall_highest_s": walls["highest"],
                "wall_certify_s": walls["certify"],
                "rows": n_rows, "device": dev.type, "card": card}
        print(json.dumps(line), flush=True)
        out.append(line)
    return out


def _cli(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="python -m kmersgwas_tpu_torch.tools.prof_r5_certify",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("n_seeds", nargs="?", type=int, default=2)
    ap.add_argument("--rows", type=int, default=8_000_000)
    ap.add_argument("--p", type=int, default=101)
    ap.add_argument("--k", type=int, default=10001)
    ap.add_argument("--batch_size", type=int, default=2_000_000)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--workdir", default=bench.WORKDIR,
                    help="where the synthetic table is built (and reused)")
    a = ap.parse_args(argv)
    main(a.n_seeds, a.rows, a.p, a.k, a.device, a.workdir, a.batch_size)


if __name__ == "__main__":
    _cli()
