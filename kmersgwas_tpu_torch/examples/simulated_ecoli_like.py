"""Self-contained end-to-end example of the port: a copy of
examples/simulated_ecoli_like/run_example.py that drives the port's CLI
(mirroring the reference's examples/resistence_e_coli/run_example.sh with
simulated reads).

Simulates a bacterial population where half the accessions carry a
resistance cassette insertion, generates reads, and runs the complete
pipeline: counting -> strand lists -> master list -> table -> kinship ->
GWAS with permutation thresholds, then the same GWAS as a 2-process
`gwas-mp`. The expected artifact, like the reference example's, is
gwas_results/kmers/pass_threshold_5per holding cassette-linked k-mers.

Usage:
    python -m kmersgwas_tpu_torch.examples.simulated_ecoli_like [workdir]
        [--device cuda|cpu]

`gwas` and `gwas-mp` run on --device (default cuda: it raises without a
card); counting and the table are host code.
"""
import argparse
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

from kmersgwas_tpu_torch.cli.__main__ import main as cli
from kmersgwas_tpu_torch.core import formats

K = 21
N_SAMPLES = 30
ROOT = Path(__file__).resolve().parents[2]


def simulate_genome(rng, n=12000):
    return "".join("ACGT"[i] for i in rng.integers(0, 4, size=n))


def write_reads(rng, path, genome, coverage=6, read_len=100):
    comp = {"A": "T", "C": "G", "G": "C", "T": "A"}
    with open(path, "w") as f:
        for i in range(coverage * len(genome) // read_len):
            s = rng.integers(0, len(genome) - read_len)
            seq = genome[s:s + read_len]
            if rng.random() < 0.5:
                seq = "".join(comp[c] for c in reversed(seq))
            f.write(f"@r{i}\n{seq}\n+\n{'I' * read_len}\n")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", default="example_out")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    a = ap.parse_args(argv)
    rng = np.random.default_rng(0)
    work = Path(a.workdir)
    work.mkdir(parents=True, exist_ok=True)
    core = simulate_genome(rng)
    cassette = simulate_genome(rng, 300)
    carriers = set(rng.choice(N_SAMPLES, N_SAMPLES // 2,
                              replace=False).tolist())

    print(f"simulating {N_SAMPLES} accessions ({len(carriers)} carriers)...")
    lines = []
    for s in range(N_SAMPLES):
        # individual SNP noise: a few private mutations per accession
        g = list(core)
        for _ in range(12):
            pos = rng.integers(0, len(g))
            g[pos] = "ACGT"[rng.integers(0, 4)]
        g = "".join(g)
        if s in carriers:
            g = g[:6000] + cassette + g[6000:]
        reads = work / f"acc{s:02d}.fq"
        write_reads(rng, reads, g)
        canon, nonc = work / f"acc{s:02d}.canon", work / f"acc{s:02d}.nonc"
        cli(["count", "-k", str(K), "-o", str(canon), "--canonize",
             "--min_count", "2", str(reads)])
        cli(["count", "-k", str(K), "-o", str(nonc), str(reads)])
        slist = work / f"acc{s:02d}.kmers"
        cli(["strand-merge", "-c", str(canon), "-n", str(nonc), "-k",
             str(K), "-o", str(slist)])
        lines.append(f"{slist} acc{s:02d}")
    (work / "kmers_list_paths.txt").write_text("\n".join(lines) + "\n")

    print("building master list + table...")
    cli(["list-kmers", "-l", str(work / "kmers_list_paths.txt"), "-k",
         str(K), "--mac", "3", "-p", "0.2", "-o", str(work / "kmers_to_use")])
    cli(["build-table", "-l", str(work / "kmers_list_paths.txt"), "-k",
         str(K), "-a", str(work / "kmers_to_use"), "-o",
         str(work / "kmers_table")])

    print("phenotype: resistance driven by cassette presence...")
    y = np.array([3.0 if s in carriers else 0.0 for s in range(N_SAMPLES)])
    y += rng.normal(scale=0.5, size=N_SAMPLES)
    formats.write_phenotypes(work / "resistance.pheno",
                             formats.PhenotypeTable(
                                 ["phenotype_value"],
                                 [f"acc{s:02d}" for s in range(N_SAMPLES)],
                                 y[:, None]))

    print(f"running GWAS on --device {a.device} (kinship + REML + "
          "permutations + LMM)...")
    common = ["--pheno", str(work / "resistance.pheno"),
              "--kmers_table", str(work / "kmers_table"), "-l", str(K),
              "-k", "200", "--permutations", "30", "--mac", "3",
              "--min_data_points", "10", "--batch_size", "16384",
              "--device", a.device]
    cli(["gwas", "--outdir", str(work / "gwas_results"), *common])

    kdir = work / "gwas_results" / "kmers"
    passed = (kdir / "pass_threshold_5per").read_text()
    n_pass = len(passed.splitlines())
    print(f"\nk-mers passing the 5% family-wise threshold: {n_pass}")
    print((kdir / "threshold_5per").read_text().strip(),
          "= -log10 threshold")
    assert n_pass > 0, "expected cassette-linked k-mers to pass"
    print("example OK")

    # the same pipeline as ONE COMMAND PER PROCESS (gwas-mp): two local
    # processes over gloo, both on --device; the kinship is recomputed by
    # the distributed kinship
    print("\nre-running as a 2-process gwas-mp...")
    os.remove(work / "kmers_table.kinship")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    args = [*common, "--outdir", str(work / "gwas_results_mp"),
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2"]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "kmersgwas_tpu_torch.cli", "gwas-mp",
         *args, "--process_id", str(pid)], env=env)
        for pid in (0, 1)]
    try:
        for pr in procs:
            assert pr.wait(timeout=600) == 0
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    mp_pass = (work / "gwas_results_mp" / "kmers"
               / "pass_threshold_5per").read_text()
    mp_set = {ln.split("\t")[0] for ln in mp_pass.splitlines()}
    sp_set = {ln.split("\t")[0] for ln in passed.splitlines()}
    assert mp_set, "gwas-mp found no passing k-mers"
    overlap = len(mp_set & sp_set) / max(1, len(sp_set))
    print(f"gwas-mp pass-set overlap with single-process: {overlap:.0%}")
    assert overlap > 0.8
    print("gwas-mp matches single-process gwas — example OK")


if __name__ == "__main__":
    main()
