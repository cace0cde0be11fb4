"""CLI dispatcher: `python -m kmersgwas_tpu_torch.cli <command> [...]`.

Port of kmersgwas_tpu/cli/__main__.py: its 17 commands with their flags,
stdout lines and output bytes. The commands that touch the card (`gwas`,
`gwas-mp`, `associate`, `associate-mp`, `kinship`, `kinship-mp`,
`kinship-bed`, `associate-snps`) take `--device` (default cuda; cuda
without a card raises); `gwas`, `associate` and `kinship` also take
`--devices N`, a mesh of N shards (parallel/sharding.mesh_for) whose
output equals one device's. The ingest and export commands (`count`,
`strand-merge`, `list-kmers`, `build-table`, `table-to-bed`,
`filter-kmers`, `kmc-import`, `kmc-export`, `histogram`) are host code,
as in the JAX package: the native ingest library where it builds, else
(or with --no-native) the numpy route, which writes the same bytes; the
route taken is told on stderr. `gwas`, `associate` and `kinship` take
`--trace PATH`: the run's spans and counters (utils.tracing) written to
PATH as Chrome-trace JSON.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np


def _add_trace(p):
    p.add_argument("--trace", default=None, metavar="PATH",
                   help="write the run's spans and counters to PATH as "
                        "Chrome-trace JSON (open it in Perfetto)")


def _add_gwas(sub):
    p = sub.add_parser("gwas", help="full k-mer GWAS pipeline (kmers_gwas.py)")
    p.add_argument("--pheno", required=True)
    p.add_argument("--kmers_table", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("-l", "--kmer_len", type=int, required=True)
    p.add_argument("-k", "--kmers_number", type=int, default=10001)
    p.add_argument("--permutations", type=int, default=100)
    p.add_argument("--maf", type=float, default=0.05)
    p.add_argument("--mac", type=int, default=5)
    p.add_argument("--min_data_points", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=2_000_000)
    p.add_argument("--pattern_counter", action="store_true")
    p.add_argument("--kinship", default=None, help="precomputed kinship TSV")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where kinship, the scan, the exact LMM and the "
                        "SNP arm run (cuda raises without a card)")
    p.add_argument("--snp_matrix", default=None,
                   help="PLINK base for the SNP arm")
    p.add_argument("--run_on_snps_one_step", action="store_true")
    p.add_argument("--run_on_snps_two_steps", action="store_true")
    p.add_argument("--snps_number", type=int, default=10001)
    p.add_argument("--dont_run_on_kmers", action="store_true")
    p.add_argument("--dtable_cache", default=None,
                   help="path for the device-native packed table cache")
    p.add_argument("--kinship_snps", action="store_true",
                   help="use kinship from the SNP matrix (requires "
                        "--snp_matrix)")
    p.add_argument("--kmers_for_no_perm_phenotype", type=int, default=None,
                   dest="n_extra_phenotype_kmers",
                   help="heap size override for the real (non-permuted) "
                        "phenotype")
    p.add_argument("--dont_remove_intermediates", action="store_true")
    p.add_argument("--lmm_backend", default="auto",
                   choices=["auto", "host64", "device32"],
                   help="exact-LMM stage backend (host64 = float64, "
                        "device32 = packed bits + float32, both on --device)")
    p.add_argument("--devices", type=int, default=None,
                   help="shard the kinship and the scan over this many "
                        "devices: round-robin over the visible cards, or "
                        "cpu shards with --device cpu")
    p.add_argument("--score_precision", default="default",
                   choices=["default", "highest"],
                   help="score GEMM precision: default = phenotypes rounded "
                        "to bf16 with f32 sums, highest = f32")
    p.add_argument("--certify_topk", action="store_true",
                   help="rank the scan's candidates by exact f64 re-scores: "
                        "the same top-k and ranks on every device")
    p.add_argument("--checkpoint", default=None,
                   help="base path for resumable kinship/scan checkpoints "
                        "(<base>.kin / <base>.scan)")
    p.add_argument("--checkpoint_every", type=int, default=20,
                   help="batches between checkpoint writes")
    _add_trace(p)

    def run(a):
        from ..pipeline.gwas import GWASConfig, run_gwas
        res = run_gwas(GWASConfig(
            pheno_path=a.pheno, kmers_table=a.kmers_table, outdir=a.outdir,
            kmer_len=a.kmer_len, n_kmers=a.kmers_number,
            n_permutations=a.permutations, maf=a.maf, mac=a.mac,
            min_data_points=a.min_data_points, batch_size=a.batch_size,
            pattern_counter=a.pattern_counter, kinship_path=a.kinship,
            seed=a.seed, device=a.device,
            run_kmers=not a.dont_run_on_kmers, snps_matrix=a.snp_matrix,
            run_snps=("one_step" if a.run_on_snps_one_step else
                      "two_steps" if a.run_on_snps_two_steps else None),
            n_snps=a.snps_number, dtable_cache=a.dtable_cache,
            kinship_snps=a.kinship_snps,
            n_extra_phenotype_kmers=a.n_extra_phenotype_kmers,
            remove_intermediates=not a.dont_remove_intermediates,
            lmm_backend=a.lmm_backend, score_precision=a.score_precision,
            certify_topk=a.certify_topk, checkpoint_base=a.checkpoint,
            checkpoint_every=a.checkpoint_every,
            n_devices=a.devices))
        th5 = res.thresholds.get("5per")
        print(f"threshold_5per={th5 if th5 is not None else 'n/a'} "
              f"pass_5per={len(res.pass_5per)} tested={res.n_tested}")
    p.set_defaults(func=run)


def _add_gwas_mp(sub):
    p = sub.add_parser(
        "gwas-mp",
        help="ONE-COMMAND multi-process GWAS: run this same command once "
             "per process with a shared coordinator; distributed kinship + "
             "process-0 transform broadcast + distributed scan + exact LMM "
             "and thresholds written by process 0 "
             "(pipeline.gwas.run_distributed_gwas)")
    p.add_argument("--pheno", required=True)
    p.add_argument("--kmers_table", required=True)
    p.add_argument("--outdir", required=True)
    p.add_argument("-l", "--kmer_len", type=int, required=True)
    p.add_argument("-k", "--kmers_number", type=int, default=10001)
    p.add_argument("--permutations", type=int, default=100)
    p.add_argument("--maf", type=float, default=0.05)
    p.add_argument("--mac", type=int, default=5)
    p.add_argument("--min_data_points", type=int, default=30)
    p.add_argument("--batch_size", type=int, default=2_000_000)
    p.add_argument("--pattern_counter", action="store_true")
    p.add_argument("--kinship", default=None, help="precomputed kinship TSV")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where each process's kinship, scan and (process "
                        "0) exact LMM run (cuda raises without a card; "
                        "process i takes card i modulo the count)")
    p.add_argument("--dtable_cache", default=None,
                   help="base path for per-process device-native table "
                        "caches")
    p.add_argument("--kmers_for_no_perm_phenotype", type=int, default=None,
                   dest="n_extra_phenotype_kmers")
    p.add_argument("--dont_remove_intermediates", action="store_true")
    p.add_argument("--lmm_backend", default="auto",
                   choices=["auto", "host64", "device32"])
    p.add_argument("--score_precision", default="default",
                   choices=["default", "highest"],
                   help="score GEMM precision: default = phenotypes rounded "
                        "to bf16 with f32 sums, highest = f32")
    p.add_argument("--certify_topk", action="store_true",
                   help="rank the scan's candidates by exact f64 re-scores, "
                        "as gwas --certify_topk")
    p.add_argument("--checkpoint", default=None,
                   help="base path for resumable per-process kinship/scan "
                        "checkpoints (<base>.kin.p<pid> / <base>.scan.p<pid>)")
    p.add_argument("--checkpoint_every", type=int, default=20,
                   help="batches between checkpoint writes")
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0")
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--process_id", type=int, required=True)

    def run(a):
        from ..parallel import multihost
        from ..pipeline.gwas import GWASConfig, run_distributed_gwas
        multihost.init_distributed(coordinator_address=a.coordinator,
                                   num_processes=a.num_processes,
                                   process_id=a.process_id)
        res = run_distributed_gwas(GWASConfig(
            pheno_path=a.pheno, kmers_table=a.kmers_table, outdir=a.outdir,
            kmer_len=a.kmer_len, n_kmers=a.kmers_number,
            n_permutations=a.permutations, maf=a.maf, mac=a.mac,
            min_data_points=a.min_data_points, batch_size=a.batch_size,
            pattern_counter=a.pattern_counter, kinship_path=a.kinship,
            seed=a.seed, device=a.device, dtable_cache=a.dtable_cache,
            n_extra_phenotype_kmers=a.n_extra_phenotype_kmers,
            remove_intermediates=not a.dont_remove_intermediates,
            lmm_backend=a.lmm_backend, score_precision=a.score_precision,
            certify_topk=a.certify_topk, checkpoint_base=a.checkpoint,
            checkpoint_every=a.checkpoint_every))
        if res is not None:
            th5 = res.thresholds.get("5per")
            print(f"threshold_5per={th5 if th5 is not None else 'n/a'} "
                  f"pass_5per={len(res.pass_5per)} tested={res.n_tested}")
        else:
            print(f"process {a.process_id}: scan complete "
                  "(process 0 writes the results)")
    p.set_defaults(func=run)


def _native_or_none(no_native: bool, command: str):
    """The native ingest library, or None for the numpy route (asked for
    with --no-native, or where the library cannot be built); the route is
    told on stderr."""
    from .. import native
    lib = None if no_native else (native if native.ingest_available()
                                  else None)
    print(f"{command}: {'native' if lib else 'numpy'} route",
          file=sys.stderr)
    return lib


def _add_count(sub):
    p = sub.add_parser("count", help="count k-mers from FASTQ/FASTA files")
    p.add_argument("-k", "--kmer_len", type=int, required=True)
    p.add_argument("-o", "--output", required=True,
                   help="binary kmer+count output")
    p.add_argument("--canonize", action="store_true")
    p.add_argument("--min_count", type=int, default=1)
    p.add_argument("--no-native", action="store_true",
                   help="force the NumPy ingest path")
    p.add_argument("reads", nargs="+")

    def run(a):
        native = _native_or_none(a.no_native, "count")
        if native is not None:
            n = native.count(a.reads, a.kmer_len, a.canonize, a.min_count,
                             a.output)
        else:
            from ..ingest import counter
            kmers, counts = counter.count_kmers_in_files(
                a.reads, a.kmer_len, canonize=a.canonize,
                min_count=a.min_count)
            _write_counts(a.output, kmers, counts)
            n = len(kmers)
        print(f"{n} distinct k-mers")
    p.set_defaults(func=run)


def _write_counts(path, kmers, counts):
    rec = np.empty(len(kmers), dtype=[("k", "<u8"), ("c", "<u8")])
    rec["k"], rec["c"] = kmers, counts
    rec.tofile(path)


# copy of kmersgwas_tpu.cli.__main__._read_counts
def _read_counts(path):
    rec = np.fromfile(path, dtype=[("k", "<u8"), ("c", "<u8")])
    return rec["k"].copy(), rec["c"].copy()


def _add_strand_merge(sub):
    p = sub.add_parser("strand-merge",
                       help="combine canonized + non-canonized counts into a "
                            "strand-flagged sorted list "
                            "(kmers_add_strand_information)")
    p.add_argument("-c", "--canonized", required=True)
    p.add_argument("-n", "--non_canonized", required=True)
    p.add_argument("-k", "--kmer_len", type=int, required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--no-native", action="store_true")

    def run(a):
        native = _native_or_none(a.no_native, "strand-merge")
        if native is not None:
            n = native.strand_merge(a.canonized, a.non_canonized,
                                    a.kmer_len, a.output)
        else:
            from ..ingest import strand
            ck, _ = _read_counts(a.canonized)
            nk, _ = _read_counts(a.non_canonized)
            strand.write_strand_list(a.output, ck, nk, a.kmer_len)
            n = len(ck)
        print(f"{n} k-mers written")
    p.set_defaults(func=run)


def _add_list_kmers(sub):
    p = sub.add_parser("list-kmers",
                       help="union + MAC/strand filter across samples "
                            "(list_kmers_found_in_multiple_samples)")
    p.add_argument("-l", "--list_kmers_files", required=True,
                   help="file with one strand-list path (and optional name) "
                        "per line")
    p.add_argument("-k", "--kmer_len", type=int, required=True)
    p.add_argument("--mac", type=int, required=True)
    p.add_argument("-p", "--min_strand_percent", type=float, required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--no-native", action="store_true")

    def run(a):
        with open(a.list_kmers_files) as f:
            paths = [ln.split()[0] for ln in f if ln.strip()]
        native = _native_or_none(a.no_native, "list-kmers")
        if native is not None:
            n = native.list_union(paths, a.kmer_len, a.mac,
                                  a.min_strand_percent, a.output,
                                  write_stats=True)
        else:
            from ..ingest import union
            n, _ = union.build_master_list(paths, a.output, a.kmer_len,
                                           a.mac, a.min_strand_percent)
        print(f"passed kmers:\t{n}")
    p.set_defaults(func=run)


def _add_build_table(sub):
    p = sub.add_parser("build-table",
                       help="build the k-mers table (build_kmers_table)")
    p.add_argument("-l", "--list_kmers_files", required=True,
                   help="file with '<path> <accession>' per line")
    p.add_argument("-k", "--kmer_len", type=int, required=True)
    p.add_argument("-a", "--all_kmers", required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("--no-native", action="store_true")

    def run(a):
        with open(a.list_kmers_files) as f:
            pairs = [ln.split() for ln in f if ln.strip()]
        paths = [x[0] for x in pairs]
        names = [x[1] if len(x) > 1 else x[0] for x in pairs]
        native = _native_or_none(a.no_native, "build-table")
        if native is not None:
            n = native.build_table(paths, names, a.all_kmers, a.output,
                                   a.kmer_len)
        else:
            from ..ingest import tablebuild
            n = tablebuild.build_table(paths, names, a.all_kmers, a.output,
                                       a.kmer_len)
        print(f"rows: {n}")
    p.set_defaults(func=run)


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
    p.add_argument("--devices", type=int, default=None,
                   help="shard the scan over this many devices: "
                        "round-robin over the visible cards, or cpu shards "
                        "with --device cpu")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scan runs (cuda raises without a card)")
    _add_trace(p)

    def run(a):
        from ..core import formats
        from ..parallel import sharding as shard_mod
        from ..pipeline import scan
        pheno = formats.read_phenotypes(a.phenotype_file)
        res = scan.associate(a.kmers_table, pheno.accessions, pheno.values,
                             pheno.names, kmer_len=a.kmer_len, n_top=a.best,
                             maf=a.maf, mac=a.mac, batch_size=a.batch_size,
                             count_patterns=a.pattern_counter,
                             first_phenotype_top=a.first_phenotype_best,
                             score_precision=a.score_precision,
                             certify_topk=a.certify_topk,
                             dtable_cache=a.dtable_cache, device=a.device,
                             mesh=shard_mod.mesh_for(a.devices, a.device))
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


def _add_associate_mp(sub):
    p = sub.add_parser(
        "associate-mp",
        help="multi-PROCESS association scan: run this command once per "
             "process with a shared coordinator; each process streams only "
             "its k-mer range of the table (parallel/multihost.py)")
    p.add_argument("-p", "--phenotype_file", required=True,
                   help="TRANSFORMED phenotype columns")
    p.add_argument("-b", "--best", type=int, default=10001)
    p.add_argument("-t", "--kmers_table", required=True)
    p.add_argument("-k", "--kmer_len", type=int, required=True)
    p.add_argument("-o", "--output_dir", required=True)
    p.add_argument("--base_name", default="pheno")
    p.add_argument("--batch_size", type=int, default=2_000_000)
    p.add_argument("--maf", type=float, default=0.05)
    p.add_argument("--mac", type=int, default=5)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where each process scans (cuda raises without a "
                        "card; process i takes card i modulo the count)")
    p.add_argument("--pattern_counter", action="store_true")
    p.add_argument("--first_phenotype_best", type=int, default=None)
    p.add_argument("--dtable_cache", default=None,
                   help="base path for the per-process device-native table "
                        "cache (<base>.mc<min>.n<n>.p<pid>of<nproc>)")
    p.add_argument("--score_precision", default="default",
                   choices=["default", "highest"],
                   help="score GEMM precision: default = phenotypes rounded "
                        "to bf16 with f32 sums, highest = f32")
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0")
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--checkpoint", default=None,
                   help="per-process checkpoint base (<path>.p<pid>.npz)")

    def run(a):
        from ..core import formats
        from ..core.table import KmersTableReader
        from ..parallel import multihost
        from ..pipeline import scan as scan_mod
        multihost.init_distributed(coordinator_address=a.coordinator,
                                   num_processes=a.num_processes,
                                   process_id=a.process_id)
        pheno = formats.read_phenotypes(a.phenotype_file)
        per_pheno, n_tested, n_patterns = multihost.run_distributed_scan(
            a.kmers_table, pheno.accessions, pheno.values, pheno.names,
            kmer_len=a.kmer_len, device=a.device, n_top=a.best, maf=a.maf,
            mac=a.mac, batch_size=a.batch_size,
            checkpoint_path=a.checkpoint, count_patterns=a.pattern_counter,
            first_phenotype_top=a.first_phenotype_best,
            dtable_cache=a.dtable_cache, score_precision=a.score_precision)
        if a.process_id == 0:     # every process holds the result: one writer
            reader = KmersTableReader(a.kmers_table,
                                      names_to_use=pheno.accessions)
            all_rows, slots = scan_mod.resolve_winners(per_pheno, a.device)
            kmer_of_row, pa_of_row = scan_mod.fetch_rows(reader, all_rows)
            base = f"{a.output_dir}/{a.base_name}"
            kmers_list, scores_list, rows_list = [], [], []
            for j in range(len(pheno.names)):
                sc, rw = per_pheno[j]
                kk = np.asarray(kmer_of_row.values[slots[j]], np.uint64)
                kmers_list.append(kk)
                scores_list.append(np.asarray(sc, np.float64))
                rows_list.append(np.asarray(rw, np.int64))
                formats.write_best_kmers_scores(
                    f"{base}.{j}.best_kmers.scores", kk, sc)
            result = scan_mod.ScanResult(
                names=list(pheno.names), scores=scores_list, rows=rows_list,
                kmers=kmers_list, n_tested=n_tested, pa_rows=pa_of_row)
            plink_bases = [f"{base}.{j}.{nm}"
                           for j, nm in enumerate(pheno.names)]
            scan_mod.export_plink(result, reader.n_used, a.kmer_len,
                                  plink_bases)
            for j in range(len(pheno.names)):
                formats.write_fam(plink_bases[j] + ".fam", pheno.accessions,
                                  pheno.values[:, j])
            with open(f"{base}.tested_kmers", "w") as f:
                f.write(f"{n_tested}\n")
            if n_patterns is not None:
                with open(f"{base}.pattern_counter", "w") as f:
                    f.write(f"{n_patterns}\n")
        print(f"process {a.process_id}: tested {n_tested} k-mers (global)")
    p.set_defaults(func=run)


def _add_kinship(sub):
    p = sub.add_parser("kinship",
                       help="kinship from k-mers table (emma_kinship_kmers)")
    p.add_argument("-t", "--kmers_table", required=True)
    p.add_argument("-k", "--kmer_len", type=int, required=False)
    p.add_argument("--maf", type=float, required=True)
    p.add_argument("--batch_size", type=int, default=1 << 20)
    p.add_argument("--devices", type=int, default=None,
                   help="shard the accumulation over this many devices: "
                        "round-robin over the visible cards, or cpu shards "
                        "with --device cpu")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the Gram runs (cuda raises without a card)")
    _add_trace(p)

    def run(a):
        from ..parallel import sharding as shard_mod
        from ..pipeline import kinship as km
        K = km.kinship_from_table(
            a.kmers_table, maf=a.maf, batch_size=a.batch_size,
            device=a.device, mesh=shard_mod.mesh_for(a.devices, a.device))
        for row in K:
            sys.stdout.write("\t".join(f"{v:g}" for v in row) + "\n")
    p.set_defaults(func=run)


def _add_kinship_mp(sub):
    p = sub.add_parser(
        "kinship-mp",
        help="multi-PROCESS kinship: run once per process with a shared "
             "coordinator; each process streams its k-mer range "
             "(parallel/multihost.run_distributed_kinship)")
    p.add_argument("-t", "--kmers_table", required=True)
    p.add_argument("--maf", type=float, required=True)
    p.add_argument("--batch_size", type=int, default=1 << 20)
    p.add_argument("-o", "--output", required=True,
                   help="kinship TSV (written by process 0)")
    p.add_argument("--dtable_cache", default=None,
                   help="base path for the per-process device-native table "
                        "cache (<base>.mc<min>.n<n>.p<pid>of<nproc>)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where each process accumulates (cuda raises "
                        "without a card; process i takes card i modulo the "
                        "count)")
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0")
    p.add_argument("--num_processes", type=int, required=True)
    p.add_argument("--process_id", type=int, required=True)
    p.add_argument("--checkpoint", default=None,
                   help="per-process checkpoint base (<path>.p<pid>)")

    def run(a):
        from ..parallel import multihost
        from ..pipeline import kinship as km
        multihost.init_distributed(coordinator_address=a.coordinator,
                                   num_processes=a.num_processes,
                                   process_id=a.process_id)
        K = multihost.run_distributed_kinship(
            a.kmers_table, maf=a.maf, batch_size=a.batch_size,
            dtable_cache=a.dtable_cache, checkpoint_path=a.checkpoint,
            device=a.device)
        if a.process_id == 0:
            km.write_kinship(a.output, K)
        print(f"process {a.process_id}: kinship over {K.shape[0]} "
              "accessions")
    p.set_defaults(func=run)


def _add_kinship_bed(sub):
    p = sub.add_parser("kinship-bed",
                       help="EMMA kinship from a PLINK bed (emma_kinship)")
    p.add_argument("bedbim_base")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the Gram runs (cuda raises without a card)")

    def run(a):
        from ..snps.kinship import emma_kinship_from_bed
        K = emma_kinship_from_bed(a.bedbim_base, device=a.device)
        for row in K:
            sys.stdout.write("\t".join(f"{v:g}" for v in row) + "\n")
    p.set_defaults(func=run)


def _add_associate_snps(sub):
    p = sub.add_parser("associate-snps",
                       help="GRAMMAR-approximate SNP prefilter "
                            "(associate_snps)")
    p.add_argument("phenotypes_file")
    p.add_argument("bedbim_base")
    p.add_argument("output_base")
    p.add_argument("n_snps", type=int)
    p.add_argument("maf", type=float)
    p.add_argument("mac", type=float)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the scores run (cuda raises without a card)")

    def run(a):
        from ..core import formats
        from ..snps.assoc import associate_snps
        pheno = formats.read_phenotypes(a.phenotypes_file)
        associate_snps(a.bedbim_base, pheno.accessions, pheno.values,
                       pheno.names, a.output_base, a.n_snps, a.maf, a.mac,
                       device=a.device)
    p.set_defaults(func=run)


def _add_table_to_bed(sub):
    p = sub.add_parser("table-to-bed",
                       help="table -> PLINK shards (kmers_table_to_bed)")
    p.add_argument("-t", "--kmers_table", required=True)
    p.add_argument("-p", "--phenotype_file", required=True)
    p.add_argument("--maf", type=float, required=True)
    p.add_argument("--mac", type=int, required=True)
    p.add_argument("-b", "--batch_size", type=int, required=True)
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-u", "--unique_patterns", action="store_true")

    def run(a):
        from ..pipeline.export import table_to_bed
        n = table_to_bed(a.kmers_table, a.output, pheno_path=a.phenotype_file,
                         maf=a.maf, mac=a.mac, batch_size=a.batch_size,
                         unique_patterns=a.unique_patterns)
        print(f"wrote {n} variants")
    p.set_defaults(func=run)


def _add_filter_kmers(sub):
    p = sub.add_parser("filter-kmers",
                       help="presence patterns of k-mers (filter_kmers)")
    p.add_argument("-t", "--kmers_table", required=True)
    p.add_argument("-k", "--kmers_file", required=True)
    p.add_argument("-o", "--output", required=True)

    def run(a):
        from ..pipeline.export import filter_kmers_to_text
        with open(a.kmers_file) as f:
            queries = [w for w in f.read().split() if w]
        n = filter_kmers_to_text(a.kmers_table, queries, a.output)
        print(f"found {n} of {len(queries)}")
    p.set_defaults(func=run)


def _add_kmc(sub):
    p = sub.add_parser("kmc-import",
                       help="convert a KMC .kmc_pre/.kmc_suf database "
                            "(version 1 or 2/3) to a binary kmer+count file")
    p.add_argument("kmc_base")
    p.add_argument("-o", "--output", required=True)

    def run(a):
        from ..ingest import kmc
        kmers, counts, k = kmc.read_kmc(a.kmc_base)
        _write_counts(a.output, kmers, counts)
        print(f"{len(kmers)} k-mers (k={k})")
    p.set_defaults(func=run)

    pe = sub.add_parser("kmc-export",
                        help="write a count file as a KMC1-format database")
    pe.add_argument("counts_file")
    pe.add_argument("-k", "--kmer_len", type=int, required=True)
    pe.add_argument("-o", "--output_base", required=True)

    def run_e(a):
        from ..ingest import kmc
        kk, cc = _read_counts(a.counts_file)
        kmc.write_kmc1(a.output_base, kk, cc, a.kmer_len)
        print(f"wrote {len(kk)} k-mers")
    pe.set_defaults(func=run_e)


def _add_histogram(sub):
    p = sub.add_parser("histogram",
                       help="k-mer count histogram "
                            "(histogram_KMC_kmers_counts)")
    p.add_argument("counts_file", help="binary kmer+count file from `count`")

    def run(a):
        from ..ingest.counter import counts_histogram
        _, counts = _read_counts(a.counts_file)
        hist = counts_histogram(counts)
        print("appearance\tcount")
        for i, c in enumerate(hist):
            print(f"{i}\t{c}")
    p.set_defaults(func=run)


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="kmersgwas_tpu_torch",
        description="k-mer GWAS in PyTorch + CUDA")
    sub = ap.add_subparsers(dest="command", required=True)
    for add in (_add_gwas, _add_gwas_mp, _add_count, _add_strand_merge,
                _add_list_kmers, _add_build_table, _add_associate,
                _add_associate_mp, _add_kinship, _add_kinship_mp,
                _add_kinship_bed, _add_associate_snps, _add_table_to_bed,
                _add_filter_kmers, _add_kmc, _add_histogram):
        add(sub)
    args = ap.parse_args(argv)
    trace = getattr(args, "trace", None)
    if trace is None:
        return args.func(args)
    from ..utils import tracing
    with tracing(trace):
        return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
