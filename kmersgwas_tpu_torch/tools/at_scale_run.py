"""End-to-end GWAS on a generated reference-format table at the 1001G
panel's width (port of tools/at_scale_run.py).

    python -m kmersgwas_tpu_torch.tools.at_scale_run [--rows 100000000]
        [--n 1008] [--workdir DIR] [--permutations 100]
        [--batch_size 2000000] [--kmers_number 10001] [--no_dtable]
        [--device cuda|cpu]

Generates a `.table` + `.names` of `--rows` random rows over `--n`
accessions (k = 31) with 8 planted causal k-mers (carrier patterns drawn
at 35 %), a phenotype of their standardized carrier sums (0.6 each) plus
unit noise, builds the .dtable cache (timed apart, unless `--no_dtable`)
and runs the port's pipeline.gwas.run_gwas on `--device`: kinship,
transform and permutations, scan, exact LMM, thresholds. Prints the result JSON (the JAX tool's fields:
rows, n_accessions, permutations, stage_seconds, pipeline_total_seconds,
scan_kmers_per_sec, kinship_kmers_per_sec, n_tested, threshold_5per,
heritability, causal_planted, causal_recovered_5per; plus device and
card) and writes it to `<workdir>/at_scale_result.json`. A table already
in `--workdir` is reused.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time

import numpy as np

from .. import bench
from ..core import codec, formats
from ..ops import _cuda
from ..utils import require_device


def gen_table(base: str, n_rows: int, n: int, kmer_len: int, seed: int = 0,
              n_causal: int = 8):
    """Reference-format .table + .names with planted causal carrier
    patterns -> (causal k-mer codes, carriers (n_causal, n) bool)."""
    names = [f"acc{i}" for i in range(n)]
    wf = (n + 63) // 64
    used_last = n - (wf - 1) * 64
    last_mask = np.uint64((1 << used_last) - 1) if used_last < 64 \
        else np.uint64(~np.uint64(0))
    rng = np.random.default_rng(seed)
    causal_rows = np.linspace(n_rows // 10, n_rows - n_rows // 10, n_causal,
                              dtype=np.int64)
    carriers = rng.random((n_causal, n)) < 0.35
    carrier_bits = np.zeros((n_causal, wf * 64), np.uint8)
    carrier_bits[:, :n] = carriers
    carrier_pa = np.packbits(carrier_bits, axis=1, bitorder="little"
                             ).view("<u8")
    causal_kmers = causal_rows.astype(np.uint64) * np.uint64(97)
    t0 = time.perf_counter()
    with open(base + ".table", "wb") as f:
        formats.write_table_header(f, n, kmer_len)
        chunk = 1 << 20
        for s in range(0, n_rows, chunk):
            m = min(chunk, n_rows - s)
            rows = np.empty((m, 1 + wf), dtype="<u8")
            rows[:, 0] = np.arange(s, s + m, dtype=np.uint64) * np.uint64(97)
            rows[:, 1:] = rng.integers(0, 1 << 63, size=(m, wf),
                                       dtype=np.uint64)
            rows[:, wf] &= last_mask
            sel = (causal_rows >= s) & (causal_rows < s + m)
            for ci in np.flatnonzero(sel):
                rows[causal_rows[ci] - s, 1:] = carrier_pa[ci]
            rows.tofile(f)
    formats.write_names(base, names)
    print(f"[gen] {n_rows:,} rows x {n} accessions in "
          f"{time.perf_counter() - t0:.1f}s "
          f"({os.path.getsize(base + '.table') / 1e9:.1f} GB)",
          file=sys.stderr, flush=True)
    return causal_kmers, carriers


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m kmersgwas_tpu_torch.tools.at_scale_run",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=100_000_000)
    ap.add_argument("--n", type=int, default=1008)
    ap.add_argument("--workdir",
                    default=os.path.join(_cuda.BUILD, "at_scale"))
    ap.add_argument("--permutations", type=int, default=100)
    ap.add_argument("--batch_size", type=int, default=2_000_000)
    ap.add_argument("-k", "--kmers_number", type=int, default=10001,
                    help="top-k per column (gwas -k)")
    ap.add_argument("--no_dtable", action="store_true",
                    help="stream the raw .table (the native squeeze) with no "
                         ".dtable cache, for disks that cannot hold both")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    from ..pipeline.gwas import GWASConfig, run_gwas

    dev = require_device(a.device)
    os.makedirs(a.workdir, exist_ok=True)
    base = os.path.join(a.workdir, f"pop{a.rows}")
    kmer_len = 31
    if not os.path.exists(base + ".table"):
        causal_kmers, carriers = gen_table(base, a.rows, a.n, kmer_len)
        np.savez(base + "_truth.npz", causal_kmers=causal_kmers,
                 carriers=carriers)
    else:
        truth = np.load(base + "_truth.npz")
        causal_kmers, carriers = truth["causal_kmers"], truth["carriers"]
        print(f"[gen] reusing {base}.table", file=sys.stderr, flush=True)

    g = carriers.astype(np.float64)
    y = (0.6 * ((g - g.mean(axis=1, keepdims=True))
                / g.std(axis=1, keepdims=True)).sum(axis=0)
         + np.random.default_rng(42).normal(size=a.n))
    names = [f"acc{i}" for i in range(a.n)]
    pheno_path = os.path.join(a.workdir, "pheno.pheno")
    formats.write_phenotypes(pheno_path, formats.PhenotypeTable(
        names=["phenotype_value"], accessions=names, values=y[:, None]))

    stage_seconds = {}
    dtable = None
    if not a.no_dtable:
        dtable = base + ".dtable"
        if not os.path.exists(dtable):
            from ..core import dtable as dt_mod
            t0 = time.perf_counter()
            dt_mod.build_dtable(base, dtable, names_to_use=names,
                                min_count=max(5, math.ceil(a.n * 0.05)))
            stage_seconds["dtable_build"] = time.perf_counter() - t0

    t_all = time.perf_counter()
    res = run_gwas(GWASConfig(
        pheno_path=pheno_path, kmers_table=base,
        outdir=os.path.join(a.workdir, "gwas_out"), kmer_len=kmer_len,
        n_permutations=a.permutations, n_kmers=a.kmers_number,
        batch_size=a.batch_size,
        dtable_cache=dtable, seed=1, device=dev))
    total = time.perf_counter() - t_all
    stage_seconds.update(res.stage_seconds)

    pass_kmers = {s for s, _ in res.pass_5per}
    causal = set(codec.decode_kmers(np.asarray(causal_kmers, np.uint64),
                                    kmer_len))
    out = {
        "rows": a.rows, "n_accessions": a.n, "permutations": a.permutations,
        "stage_seconds": stage_seconds, "pipeline_total_seconds": total,
        "scan_kmers_per_sec": (res.n_tested / stage_seconds["scan"]
                               if stage_seconds.get("scan") else None),
        "kinship_kmers_per_sec": (a.rows / stage_seconds["kinship"]
                                  if stage_seconds.get("kinship") else None),
        "n_tested": res.n_tested,
        "threshold_5per": res.thresholds.get("5per"),
        "heritability": res.heritability,
        "causal_planted": len(causal),
        "causal_recovered_5per": len(pass_kmers & causal),
        "device": dev.type, "card": bench.card_line(dev),
    }
    path = os.path.join(a.workdir, "at_scale_result.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
