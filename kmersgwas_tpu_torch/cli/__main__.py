"""CLI dispatcher: `python -m kmersgwas_tpu_torch.cli <command> [...]`.

Port of kmersgwas_tpu/cli/__main__.py; only `associate` is ported so far.
"""
from __future__ import annotations

import argparse
import sys


def _add_associate(sub):
    p = sub.add_parser("associate", help="association scan (associate_kmers)")
    p.add_argument("-p", "--phenotype_file", required=True)
    p.add_argument("-b", "--base_name", required=True)
    p.add_argument("-o", "--output_dir", default=".")
    p.add_argument("--kmers_table", required=True)
    p.add_argument("-n", "--best", type=int, default=10001)
    p.add_argument("--batch_size", type=int, default=2_000_000)
    p.add_argument("--kmer_len", type=int, required=True)
    p.add_argument("--maf", type=float, default=0.05)
    p.add_argument("--mac", type=int, default=5)
    p.add_argument("--pattern_counter", action="store_true")
    p.add_argument("--kmers_scores", action="store_true")
    p.add_argument("--first_phenotype_best", type=int, default=None)
    p.add_argument("--score_precision", default="default",
                   choices=["default", "highest"],
                   help="score GEMM precision: default = phenotypes rounded "
                        "to bf16 with f32 sums, highest = f32")
    p.add_argument("--certify_topk", action="store_true",
                   help="carry a candidate band and exactly re-score it in "
                        "f64 at finalize, certifying the selected set "
                        "equals the exact-score top-k")
    p.add_argument("--dtable_cache", default=None,
                   help="path for the device-native packed table cache")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scan runs (cuda raises without a card)")

    def run(a):
        from kmersgwas_tpu.core import formats
        from ..pipeline import scan
        pheno = formats.read_phenotypes(a.phenotype_file)
        res = scan.associate(a.kmers_table, pheno.accessions, pheno.values,
                             pheno.names, kmer_len=a.kmer_len, n_top=a.best,
                             maf=a.maf, mac=a.mac, batch_size=a.batch_size,
                             count_patterns=a.pattern_counter,
                             first_phenotype_top=a.first_phenotype_best,
                             score_precision=a.score_precision,
                             certify_topk=a.certify_topk,
                             dtable_cache=a.dtable_cache, device=a.device)
        if res.certified is not None:
            bad = [res.names[j] for j, c in enumerate(res.certified) if not c]
            if bad:
                print(f"WARNING: top-k certificate FAILED for "
                      f"{len(bad)} column(s) ({', '.join(bad[:5])}...) — "
                      "the candidate band was too narrow; results are the "
                      "best-effort exact re-rank. Rerun with "
                      "--score_precision highest for a guaranteed set.",
                      file=sys.stderr)
            else:
                print(f"top-k certificate: all {len(res.certified)} "
                      "columns certified exact", file=sys.stderr)
        base = f"{a.output_dir}/{a.base_name}"
        if a.kmers_scores:
            for j, name in enumerate(res.names):
                formats.write_best_kmers_scores(
                    f"{base}.{j}.best_kmers.scores", res.kmers[j], res.scores[j])
        scan.export_plink(res, len(pheno.accessions), a.kmer_len,
                          [f"{base}.{j}.{n}" for j, n in enumerate(res.names)])
        for j, name in enumerate(res.names):
            formats.write_fam(f"{base}.{j}.{name}.fam", pheno.accessions,
                              pheno.values[:, j])
        with open(f"{base}.tested_kmers", "w") as f:
            f.write(f"{res.n_tested}\n")
        if res.n_patterns is not None:
            with open(f"{base}.pattern_counter", "w") as f:
                f.write(f"{res.n_patterns}\n")
        print(f"tested {res.n_tested} k-mers")
    p.set_defaults(func=run)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="kmersgwas_tpu_torch",
        description="k-mer GWAS association scan in PyTorch + CUDA")
    sub = ap.add_subparsers(dest="command", required=True)
    _add_associate(sub)
    args = ap.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
