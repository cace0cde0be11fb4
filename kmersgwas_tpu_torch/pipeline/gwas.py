"""End-to-end k-mer GWAS pipeline, single process (port of
kmersgwas_tpu/pipeline/gwas.py; the reference's kmers_gwas.py:50-274).

  1. phenotype load + per-accession averaging        (average_phenotypes.awk)
  2. intersect phenotype x kinship x table accessions (align_kinship_phenotype.py)
  3. REML variance components, covariance-preserving permutations,
     GRAMMAR transform                                (transform_and_permute_phenotypes.R)
  3b. optional SNP arm: bed planes, the GRAMMAR prefilter and the exact
     LMM on the SNPs                                 (kmers_gwas.py:170-223)
  4. association scan on the card, top-k per column  (associate_kmers)
  5. exact ML-LRT mixed model on the candidates       (GEMMA -lmm 2 farm)
  6. permutation thresholds + pass_threshold files    (functions.py awk post-processing)

Where each stage runs: kinship (K7, or from the SNP bed with
`kinship_snps`), the scan (K1, K2), the exact LMM and the SNP arm on
`cfg.device` (the kinship and the scan sharded over `cfg.n_devices`
shards of a parallel/sharding mesh when it is > 1); stage 3 in float64 on
the host CPU, where the JAX package
pins it too (stats/transform.py says why). "cuda" without a card raises;
no stage moves to the CPU when the card is missing or a kernel fails.

Artifacts carry the reference's names under `outdir`. `run_distributed_gwas`
is the same pipeline over several processes (the `gwas-mp` command): the
distributed kinship and scan of parallel/multihost.py, the transform on
process 0 broadcast to all, and stages 5-6 on process 0 through the same
`_post_scan_stages`.
"""
from __future__ import annotations

import contextlib
import functools
import gzip
import json
import math
import os
import shutil
import time
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from ..core import codec, formats
from ..parallel import sharding as shard_mod
from ..snps import kinship as snp_kinship
from ..stats import lmm as lmm_mod
from ..stats import transform as transform_mod
from ..utils import StageTimer, require_device
from . import kinship as kinship_mod
from . import scan as scan_mod
from . import snp_gwas
from .align import average_phenotypes, intersect_accessions


@dataclass
class GWASConfig:
    pheno_path: str
    kmers_table: str
    outdir: str
    kmer_len: int
    n_kmers: int = 10001
    n_permutations: int = 100
    maf: float = 0.05
    mac: int = 5
    min_data_points: int = 30
    batch_size: int = 2_000_000
    pattern_counter: bool = False
    kinship_maf: float = 0.05
    kinship_path: str | None = None     # precomputed kinship (else from table)
    seed: int = 0                       # permutation draws
                                        # (numpy.random.Generator)
    device: str = "cuda"                # kinship, scan and LMM ("cuda"
                                        # raises without a card)
    lmm_grid: int = 64
    lmm_refine: int = 40
    lmm_backend: str = "auto"           # "auto" | "host64" | "device32":
                                        # host64 = float64 (R/GEMMA
                                        # precision) on `device`; device32 =
                                        # packed bits + float32 on `device`;
                                        # auto picks device32 for large
                                        # candidate sets on the card
    run_kmers: bool = True              # False: stop after the SNP arm
    snps_matrix: str | None = None      # PLINK base of the SNP arm
    run_snps: str | None = None         # None | "one_step" | "two_steps"
    n_snps: int = 10001
    dtable_cache: str | None = None
    kinship_snps: bool = False          # kinship from snps_matrix
    n_extra_phenotype_kmers: int | None = None  # heap size override for the
                                        # real phenotype column
                                        # (--kmers_for_no_perm_phenotype)
    remove_intermediates: bool = True   # reference default: delete permutation
                                        # PLINK artifacts + gzip assoc.txt
                                        # (kmers_gwas.py:259-271)
    n_devices: int | None = None        # >1: shard the scan AND kinship
                                        # over a device mesh of this many
                                        # shards (sharding.mesh_for)
    checkpoint_base: str | None = None  # base path for resumable kinship and
                                        # scan checkpoints (<base>.kin,
                                        # <base>.scan)
    checkpoint_every: int = 20          # batches between checkpoint writes
    score_precision: str = "default"    # scan score-GEMM precision, as
                                        # associate --score_precision
    certify_topk: bool = False          # rank the scan's candidates by f64
                                        # re-scores (associate --certify_topk):
                                        # the same top-k and ranks on every
                                        # device, where f32 near-ties could
                                        # swap between the card and the CPU


# copy of kmersgwas_tpu.pipeline.gwas.GWASResult
@dataclass
class GWASResult:
    thresholds: dict                    # {"5per": x, "10per": y} in -log10(p)
    best_pvals: dict                    # column name -> -log10(best p)
    pass_5per: list = field(default_factory=list)   # (kmer_str, p) passing 5%
    pass_10per: list = field(default_factory=list)
    heritability: float = 0.0
    n_tested: int = 0
    stage_seconds: dict = field(default_factory=dict)  # per-stage wall-clock


def _persist_kinship(cfg: GWASConfig, out: Path, K_full, log) -> None:
    """Cache the computed kinship beside the table, falling back into
    `outdir` when the table's directory is read-only: the kinship stage
    must never be lost to a permissions error."""
    try:
        kinship_mod.write_kinship(cfg.kmers_table + ".kinship", K_full)
    except OSError as e:
        alt = out / "full_table.kinship"
        kinship_mod.write_kinship(alt, K_full)
        log(f"kinship cache beside the table failed ({e}); wrote {alt} — "
            "pass it via --kinship on reruns")


def _stage_log(dev: torch.device):
    """(log_lines, stage_seconds, log, stage) of one pipeline run: `log`
    appends a line to log_file's, `stage(name)` times a block into
    stage_seconds, the device synchronized before the clock is read."""
    log_lines = []
    stage_seconds = {}

    def log(msg):
        log_lines.append(str(msg))

    @contextlib.contextmanager
    def stage(name):
        t0 = time.perf_counter()
        yield
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        stage_seconds[name] = stage_seconds.get(name, 0.0) + dt
        log(f"[stage] {name}: {dt:.2f}s")
    return log_lines, stage_seconds, log, stage


def _prepare(cfg: GWASConfig, dev: torch.device, out: Path, log, stage,
             kinship_fn, transform_fn, write: bool = True,
             kinship_note: str = ""):
    """Stages 1-3 of run_gwas and run_distributed_gwas -> (used, y, K, tr).

    kinship_fn(table, device=, maf=, dtable_cache=, checkpoint_path=,
    checkpoint_every=) computes the kinship when none is given or cached
    (kinship_from_table, or the distributed run_distributed_kinship);
    transform_fn(y, K) the TransformResult (run_distributed_gwas's runs
    on process 0 and broadcasts it). Only a process with `write` writes
    the kinship cache and the pheno.* files."""
    # 1. phenotype: load + average duplicate accessions
    pheno = formats.read_phenotypes(cfg.pheno_path)
    accs, vals = average_phenotypes(pheno.accessions, pheno.values[:, 0])
    table_names = formats.read_names(cfg.kmers_table)

    # 2. kinship (precomputed > from the SNP matrix with kinship_snps >
    # cached beside the table > from the table) + intersection. The SNP
    # kinship is cached beside the bed and follows the .fam's order
    # (kmers_gwas.py:68-87)
    kin_names = table_names
    if cfg.kinship_path:
        K_full = kinship_mod.read_kinship(cfg.kinship_path)
    elif cfg.kinship_snps and cfg.snps_matrix:
        kin_names = formats.read_fam_names(cfg.snps_matrix + ".fam")
        if os.path.exists(cfg.snps_matrix + ".kinship"):
            K_full = kinship_mod.read_kinship(cfg.snps_matrix + ".kinship")
            log("Using kinship calculated on SNPs")
        else:
            log("computing kinship from SNP matrix")
            with stage("snp_kinship"):
                K_full = snp_kinship.emma_kinship_from_bed(cfg.snps_matrix,
                                                           device=dev)
            kinship_mod.write_kinship(cfg.snps_matrix + ".kinship", K_full)
    elif os.path.exists(cfg.kmers_table + ".kinship"):
        K_full = kinship_mod.read_kinship(cfg.kmers_table + ".kinship")
    else:
        log("computing kinship from k-mers table" + kinship_note)
        with stage("kinship"):
            # the scan's dtable cache feeds kinship too when its stored
            # filter matches (kinship_from_table validates and falls back)
            K_full = kinship_fn(
                cfg.kmers_table, device=dev, maf=cfg.kinship_maf,
                dtable_cache=cfg.dtable_cache,
                checkpoint_path=(cfg.checkpoint_base + ".kin"
                                 if cfg.checkpoint_base else None),
                checkpoint_every=cfg.checkpoint_every)
        if write:
            _persist_kinship(cfg, out, K_full, log)

    used, y, K = intersect_accessions(accs, vals, kin_names, K_full,
                                      table_names)
    n = len(used)
    if n < cfg.min_data_points:
        if write:
            (out / "NOT_ENOUGH_DATA").touch()
        raise ValueError(f"only {n} phenotyped accessions "
                         f"(< {cfg.min_data_points})")
    if write:
        np.savetxt(out / "pheno.kinship", K, delimiter="\t")
        formats.write_phenotypes(out / "pheno.phenotypes",
                                 formats.PhenotypeTable(
                                     names=["phenotype_value"],
                                     accessions=used, values=y[:, None]))

    # 3. transform + permutations (float64, host CPU by design)
    with stage("transform"):
        tr = transform_fn(y, K)
    log(f"EMMA vg={tr.vg} ve={tr.ve} herit={tr.heritability}")
    if write:
        formats.write_phenotypes(out / "pheno.phenotypes_and_permutations",
                                 formats.PhenotypeTable(tr.names, used,
                                                        tr.phenotypes))
        formats.write_phenotypes(
            out / "pheno.phenotypes_permuted_transformed",
            formats.PhenotypeTable(tr.names, used, tr.transformed))
    return used, y, K, tr


def run_gwas(cfg: GWASConfig) -> GWASResult:
    dev = require_device(cfg.device)
    # the kinship and the scan shard over the same mesh
    # (kmersgwas_tpu/pipeline/gwas.py:183-187, :264-268)
    mesh = shard_mod.mesh_for(cfg.n_devices, dev)
    out = Path(cfg.outdir)
    out.mkdir(parents=True, exist_ok=True)
    log_lines, stage_seconds, log, stage = _stage_log(dev)
    used, y, K, tr = _prepare(
        cfg, dev, out, log, stage,
        functools.partial(kinship_mod.kinship_from_table, mesh=mesh),
        lambda y, K: transform_mod.transform_and_permute(
            y, K, cfg.n_permutations, seed=cfg.seed))
    n = len(used)

    # 3b. optional SNP arm (kmers_gwas.py:179-223)
    snp_summary = {}
    if cfg.run_snps:
        if cfg.snps_matrix is None:
            raise ValueError("run_snps requires snps_matrix")
        w_eig_s, U_eig_s = np.linalg.eigh(K)
        snp_summary = snp_gwas.run_snp_arm(
            cfg.snps_matrix, cfg.outdir, used, tr.phenotypes,
            tr.transformed, tr.names, w_eig_s, U_eig_s, mode=cfg.run_snps,
            n_snps=cfg.n_snps, maf=cfg.maf, mac=cfg.mac,
            n_permutations=cfg.n_permutations, lmm_grid=cfg.lmm_grid,
            lmm_refine=cfg.lmm_refine, device=dev)
        for name, v in snp_summary["stage_seconds"].items():
            stage_seconds[name] = v
            log(f"[stage] {name}: {v:.2f}s")
        log(f"snps: {snp_summary['n_tests']} exact LMM tests")

    if not cfg.run_kmers:
        (out / "log_file").write_text("\n".join(log_lines) + "\n")
        return GWASResult(thresholds=snp_summary.get("thresholds", {}),
                          best_pvals=snp_summary.get("best_pvals", {}),
                          heritability=tr.heritability,
                          stage_seconds=stage_seconds)

    # 4. association scan -> top-k per column
    kmers_dir = out / "kmers"
    kmers_dir.mkdir(exist_ok=True)
    with stage("scan"):
        result = scan_mod.associate(
            cfg.kmers_table, used, tr.transformed, tr.names,
            kmer_len=cfg.kmer_len, device=dev, n_top=cfg.n_kmers,
            maf=cfg.maf, mac=cfg.mac, batch_size=cfg.batch_size,
            count_patterns=cfg.pattern_counter,
            dtable_cache=cfg.dtable_cache,
            first_phenotype_top=cfg.n_extra_phenotype_kmers,
            score_precision=cfg.score_precision,
            certify_topk=cfg.certify_topk, mesh=mesh,
            checkpoint_path=(cfg.checkpoint_base + ".scan"
                             if cfg.checkpoint_base else None),
            checkpoint_every=cfg.checkpoint_every)
    return _post_scan_stages(cfg, out, kmers_dir, result, tr, used, K, n,
                             log, log_lines, stage_seconds)


def _lmm_backend(cfg: GWASConfig, dev: torch.device, m_total: int,
                 n: int) -> str:
    """The reference's rule (kmersgwas_tpu/pipeline/gwas.py:328-332):
    device32 above 2e8 variant-tests x samples on an accelerator."""
    if cfg.lmm_backend != "auto":
        return cfg.lmm_backend
    return "device32" if m_total * n > 2e8 and dev.type == "cuda" \
        else "host64"


def _post_scan_stages(cfg: GWASConfig, out: Path, kmers_dir: Path, result,
                      tr, used, K, n: int, log, log_lines,
                      stage_seconds) -> GWASResult:
    """Stages 5-6 (exact LMM on the candidates, permutation thresholds,
    pass files, cleanup, summary) from a ScanResult and a transform.
    Inputs are plain numpy arrays, so a multi-process driver can call it
    on its merged candidates (the JAX package's run_distributed_gwas does)
    and write the same artifacts."""
    dev = require_device(cfg.device)
    (kmers_dir / "pheno.tested_kmers").write_text(f"{result.n_tested}\n")
    for sub, v in result.timings.items():
        stage_seconds[f"scan.{sub}"] = v
        log(f"[stage] scan.{sub}: {v:.2f}s")
    if result.n_patterns is not None:
        (kmers_dir / "pheno.pattern_counter").write_text(
            f"{result.n_patterns}\n")

    # winners' PLINK artifacts per column, reference-named pheno.<j>.<name>.*
    # (associate_kmers' pass-2 export + the fam rewrite with UNtransformed
    # values, kmers_gwas.py:152-160)
    t_art = time.perf_counter()
    plink_bases = [str(kmers_dir / f"pheno.{j}.{name}")
                   for j, name in enumerate(tr.names)]
    scan_mod.export_plink(result, n, cfg.kmer_len, plink_bases)
    for j, base in enumerate(plink_bases):
        formats.write_fam(base + ".fam", used, tr.phenotypes[:, j])
    artifacts_s = time.perf_counter() - t_art

    # 5. exact LMM on the candidates: columns in chunks of one candidate
    # count (the reference's ~101-process GEMMA farm, functions.py:61-66),
    # packed bits shipped to the device and unpacked there. K's
    # eigendecomposition is n x n host work, as in the reference.
    w_eig, U_eig = np.linalg.eigh(K)
    output_dir = kmers_dir / "output"
    output_dir.mkdir(exist_ok=True)
    lmm_timer = StageTimer("lmm", "variants")
    lmm_t0 = time.perf_counter()
    results_by_col = {}
    # group columns by candidate count so stacks are rectangular (column 0
    # may use a different heap size via n_extra_phenotype_kmers)
    by_m = {}
    for j in range(len(tr.names)):
        by_m.setdefault(len(result.rows[j]), []).append(j)
    max_m = max(by_m) if by_m else 1
    m_total = sum(m * len(cs) for m, cs in by_m.items())
    backend = _lmm_backend(cfg, dev, m_total, n)
    log(f"lmm backend: {backend} ({m_total} variant-tests, n={n})")
    if backend == "device32":
        dtype = torch.float32
        chunk_cols = max(1, int(1e9 // max(1, 4 * n * max_m)))
    elif backend == "host64":
        dtype = torch.float64
        chunk_cols = max(1, int(8e8 // max(1, 8 * n * max_m)))
    else:
        raise ValueError(f"unknown lmm_backend {cfg.lmm_backend!r}")
    n64 = (n + 63) // 64
    for m, cols in sorted(by_m.items()):
        if m == 0:
            for j in cols:
                results_by_col[j] = (np.empty(0), np.empty(0), np.empty(0))
            continue
        for s in range(0, len(cols), chunk_cols):
            grp = cols[s:s + chunk_cols]
            # UNtransformed columns (kmers_gwas.py:152-160)
            ys = np.stack([tr.phenotypes[:, j] - tr.phenotypes[:, j].mean()
                           for j in grp])
            gp = np.stack([
                np.asarray(result.pa_rows.take(result.rows[j]))
                for j in grp]).reshape(len(grp), m, n64).view("<u4")
            res = lmm_mod.lmm_scan_columns_packed(
                gp, ys, w_eig, U_eig, n=n, n_grid=cfg.lmm_grid,
                n_refine=cfg.lmm_refine, device=dev, dtype=dtype)
            fields = [f.to("cpu", torch.float64).numpy()
                      for f in (res.p_lrt, res.log10_lambda, res.beta)]
            for gi, j in enumerate(grp):
                results_by_col[j] = tuple(f[gi] for f in fields)
            lmm_timer.add(m * len(grp))
    lmm_timer.done()
    stage_seconds["lmm"] = time.perf_counter() - lmm_t0
    log(f"[stage] lmm: {stage_seconds['lmm']:.2f}s")

    t_art = time.perf_counter()
    best_pvals = {}
    first_assoc = None
    for j, cname in enumerate(tr.names):
        pvals, lam, beta = results_by_col[j]
        _write_assoc_txt(output_dir / f"{cname}.assoc.txt", result, j,
                         cfg.kmer_len, n, pvals, lam, beta)
        best = float(pvals.min()) if len(pvals) else 1.0
        best_pvals[cname] = -math.log10(max(best, 1e-300))
        if j == 0:
            first_assoc = (result.kmers[j], pvals)

    # 6. permutation thresholds + pass files
    th5 = transform_mod.permutation_threshold(
        best_pvals, cfg.n_permutations, 0.05) \
        if cfg.n_permutations else float("inf")
    th10 = transform_mod.permutation_threshold(
        best_pvals, cfg.n_permutations, 0.10) \
        if cfg.n_permutations else float("inf")
    (kmers_dir / "threshold_5per").write_text(f"{th5:f}\n")
    (kmers_dir / "threshold_10per").write_text(f"{th10:f}\n")
    with open(kmers_dir / "best_pvals", "w") as f:
        for name, v in best_pvals.items():
            f.write(f"{name}\t{v}\n")

    pass5, pass10 = [], []
    if first_assoc is not None and len(first_assoc[1]):
        kk, pp = first_assoc
        strs = codec.decode_kmers(kk, cfg.kmer_len)
        for s, p in zip(strs, pp):
            mlp = -math.log10(max(p, 1e-300))
            if mlp > th5:
                pass5.append((s, float(p)))
            if mlp > th10:
                pass10.append((s, float(p)))
    for fname, rows_ in (("pass_threshold_5per", pass5),
                         ("pass_threshold_10per", pass10)):
        with open(kmers_dir / fname, "w") as f:
            for s, p in rows_:
                f.write(f"{s}\t{p:.6e}\n")

    # clean intermediates: drop permutation-column PLINK + assoc artifacts,
    # gzip the real phenotype's assoc table (kmers_gwas.py:259-271; disabled
    # by --dont_remove_intermediates)
    if cfg.remove_intermediates:
        for j, name in enumerate(tr.names):
            if name == "phenotype_value":
                continue
            for ext in (".bed", ".bim", ".fam"):
                Path(plink_bases[j] + ext).unlink(missing_ok=True)
            (output_dir / f"{name}.assoc.txt").unlink(missing_ok=True)
        src = output_dir / "phenotype_value.assoc.txt"
        if src.exists():
            # mtime=0: identical content -> identical .gz bytes
            with open(src, "rb") as fi, open(str(src) + ".gz", "wb") as fz, \
                    gzip.GzipFile(fileobj=fz, mode="wb", mtime=0) as fo:
                shutil.copyfileobj(fi, fo)
            src.unlink()
    stage_seconds["artifacts"] = artifacts_s + time.perf_counter() - t_art
    log(f"[stage] artifacts: {stage_seconds['artifacts']:.2f}s")

    (out / "log_file").write_text("\n".join(log_lines) + "\n")
    (out / "summary.json").write_text(json.dumps({
        "n_accessions": n, "heritability": tr.heritability,
        "threshold_5per": th5, "threshold_10per": th10,
        "n_tested": result.n_tested,
        # provenance: which exact-LMM backend produced the p-values
        "lmm_backend": backend,
        "score_precision": cfg.score_precision,
        "n_pass_5per": len(pass5), "n_pass_10per": len(pass10),
        "stage_seconds": {k: round(v, 3) for k, v in stage_seconds.items()},
    }, indent=2))
    return GWASResult(thresholds={"5per": th5, "10per": th10},
                      best_pvals=best_pvals, pass_5per=pass5,
                      pass_10per=pass10, heritability=tr.heritability,
                      n_tested=result.n_tested, stage_seconds=stage_seconds)


# copy of kmersgwas_tpu.pipeline.gwas._pa_bits_batch
def _pa_bits_batch(pa_words: np.ndarray, n: int) -> np.ndarray:
    """(m, n64) packed uint64 -> (m, n) float64 bit matrix, one unpack."""
    if pa_words.size == 0:
        # zeros, not empty: a zero-row caller must never consume
        # uninitialized allele frequencies
        return np.zeros((pa_words.shape[0], n))
    bits = np.unpackbits(np.ascontiguousarray(pa_words).view(np.uint8),
                         axis=1, bitorder="little")
    return bits[:, :n].astype(np.float64)


# copy of kmersgwas_tpu.pipeline.gwas._write_assoc_txt
def _write_assoc_txt(path, result, j, kmer_len, n, pvals, lam, beta):
    """GEMMA-compatible assoc.txt: 9 columns, p_lrt in column 9 — the layout
    the reference's awk post-processing consumes (functions.py:93-105)."""
    kk = result.kmers[j]
    strs = codec.decode_kmers(kk, kmer_len) if len(kk) else []
    pa = np.asarray(result.pa_rows.take(result.rows[j][:len(strs)])) \
        if len(strs) else np.empty((0, 0), "<u8")
    afs = _pa_bits_batch(pa, n).mean(axis=1) if pa.size \
        else np.zeros(len(strs))
    with open(path, "w") as f:
        f.write("chr\trs\tps\tn_miss\tallele1\tallele0\taf\tl_mle\tp_lrt\n")
        for i, s in enumerate(strs):
            f.write(f"0\t{s}_{i+1}\t0\t0\t1\t0\t{afs[i]:.6f}\t"
                    f"{10**lam[i]:.6e}\t{pvals[i]:.6e}\n")


def run_distributed_gwas(cfg: GWASConfig):
    """The one-command multi-process GWAS (port of kmersgwas_tpu.pipeline.
    gwas.run_distributed_gwas): every process calls this in lockstep after
    `parallel.multihost.init_distributed()`, on its own device (process i
    takes card i modulo the count, so several may share one card).

      1-2. phenotype load/averaging + the accession intersection (every
           process, deterministic host work)
      2b.  kinship: given, cached beside the table, or the distributed
           kinship (K7 on each process's k-mer span; process 0 persists it)
      3.   REML + permutations + GRAMMAR transform on process 0 only, its
           float64 arrays broadcast bit for bit (sharding.broadcast_np), so
           every process scans the same columns
      4.   the distributed scan (K3 on each span)
      5-6. on process 0: the winners' rows (fetch_rows), the selection of
           `associate` (select_candidates, certify_topk included) and the
           same `_post_scan_stages` as `run_gwas`, so equal candidates
           write equal artifacts; summary.json gains "n_processes"

    Returns the GWASResult on process 0 and None on the others, which
    return after the scan's last collective.

    `cfg.checkpoint_base` makes both long stages resumable per process
    (`<base>.kin.p<pid>.npz` / `<base>.scan.p<pid>.npz`), refused under
    another topology. The SNP arm is single-process only (run_gwas): its
    options raise ValueError, as in the JAX package."""
    from ..core.table import KmersTableReader
    from ..parallel import multihost

    if cfg.run_snps or cfg.kinship_snps or not cfg.run_kmers:
        raise ValueError("the SNP arm is single-process only; use run_gwas")
    dev = require_device(cfg.device)
    n_proc, pid = shard_mod.world()
    out = Path(cfg.outdir)
    out.mkdir(parents=True, exist_ok=True)
    log_lines, stage_seconds, log, stage = _stage_log(dev)

    def transform(y, K):
        """The transform once, on process 0, broadcast bit for bit: no
        process recomputes anything numeric."""
        n = len(y)
        if pid == 0:
            tr0 = transform_mod.transform_and_permute(
                y, K, cfg.n_permutations, seed=cfg.seed)
            payload = (tr0.phenotypes, tr0.transformed,
                       np.array([tr0.vg, tr0.ve, tr0.heritability]))
        else:
            z = np.zeros((n, 1 + cfg.n_permutations))
            payload = (z, z.copy(), np.zeros(3))
        if n_proc > 1:
            payload = tuple(shard_mod.broadcast_np(a) for a in payload)
        phen, transf, vvh = payload
        names = ["phenotype_value"] + [f"P{i}" for i in
                                       range(1, cfg.n_permutations + 1)]
        return transform_mod.TransformResult(
            vg=float(vvh[0]), ve=float(vvh[1]), heritability=float(vvh[2]),
            names=names, phenotypes=phen, transformed=transf)

    used, y, K, tr = _prepare(cfg, dev, out, log, stage,
                              multihost.run_distributed_kinship, transform,
                              write=pid == 0, kinship_note=" (distributed)")
    n = len(used)

    # 4. distributed association scan; with certify_topk every column
    # carries associate's k_eff candidates (n_top, first_phenotype_top and
    # the band), so the selection below sees what associate's sees
    kmers_dir = out / "kmers"
    kmers_dir.mkdir(exist_ok=True)
    first = cfg.n_extra_phenotype_kmers
    if cfg.certify_topk:
        scan_top = max(cfg.n_kmers, first or 0) + scan_mod.CERTIFY_BAND
        scan_first = None
    else:
        scan_top, scan_first = cfg.n_kmers, first
    with stage("scan"):
        per_pheno, n_tested, n_patterns = multihost.run_distributed_scan(
            cfg.kmers_table, used, tr.transformed, tr.names,
            kmer_len=cfg.kmer_len, device=dev, n_top=scan_top, maf=cfg.maf,
            mac=cfg.mac, batch_size=cfg.batch_size,
            first_phenotype_top=scan_first,
            count_patterns=cfg.pattern_counter,
            dtable_cache=cfg.dtable_cache,
            score_precision=cfg.score_precision,
            checkpoint_path=(cfg.checkpoint_base + ".scan"
                             if cfg.checkpoint_base else None),
            checkpoint_every=cfg.checkpoint_every)
    if pid != 0:
        return None     # every process holds the candidates: one writer

    # 5-6. winners + exact LMM + thresholds on process 0, through the code
    # of single-process run_gwas
    t0 = time.perf_counter()
    reader = KmersTableReader(cfg.kmers_table, names_to_use=used)
    all_rows, slots = scan_mod.resolve_winners(per_pheno, dev)
    kmer_of_row, pa_of_row = scan_mod.fetch_rows(reader, all_rows)
    timings = {"fetch": time.perf_counter() - t0}
    t0 = time.perf_counter()
    scores, rows, kmers, certified = scan_mod.select_candidates(
        per_pheno, slots, kmer_of_row, pa_of_row, tr.transformed,
        reader.n_used, cfg.n_kmers, first, cfg.certify_topk)
    if cfg.certify_topk:
        timings["certify"] = time.perf_counter() - t0
    result = scan_mod.ScanResult(
        names=list(tr.names), scores=scores, rows=rows, kmers=kmers,
        n_tested=n_tested, n_patterns=n_patterns, pa_rows=pa_of_row,
        timings=timings, certified=certified)
    res = _post_scan_stages(cfg, out, kmers_dir, result, tr, used, K, n,
                            log, log_lines, stage_seconds)
    # provenance: the distributed topology
    summary_path = out / "summary.json"
    summary = json.loads(summary_path.read_text())
    summary["n_processes"] = n_proc
    summary_path.write_text(json.dumps(summary, indent=2))
    return res
