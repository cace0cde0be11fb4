"""GRAMMAR-Gamma approximate SNP association (port of
kmersgwas_tpu/snps/assoc.py; associate_snps).

Reference score (src/snps_multiple_databases.cpp:157-172), with
heterozygous (+1/2 dose) and missing genotypes:

  yigi  = sum y_i g_i          (g = presence + het/2)
  ysum  = sum over OBSERVED samples of y_i
  score = (N*yigi - S_gi*ysum)^2 / (N*(N*S_gi2 - S_gi^2)),  N = #observed
  score = 0 when S_gi < mac or (N - S_gi) < mac

The JAX package computes this as an XLA GEMM (no Pallas kernel), and so
does the port: the planes unpacked on the device, two float32 products
against the phenotype columns (TF32 off), in blocks of SNPs. Every column
is scored in one pass. The top-N per column keeps the JAX package's
order, np.argsort(-scores, kind="stable") (on equal scores the lower SNP
index first), then row-sorted like get_rows_sorted_indices
(best_associations_heap.cpp:135-147). Selected SNPs are re-exported from
the original bed/bim bytes (snps_multiple_databases.cpp:246-286).

Traced (utils.span): `snp_scores` (the scores of every column) and
`snp_topn` (the per-column sort and the indices to the host).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..core import formats
from ..ops.bitplanes import unpack_bits
from ..utils import recording, require_device, span
from .bed import SNPPlanes, load_bed_planes

# elements of one (SNPs, n_pad) float32 block of unpacked doses
_SCORE_BLOCK_ELEMS = 1 << 26


@span("snp_scores")
def snp_scores(presence, het, nonmiss, s_gi, s_gi2, total, y_padded, *,
               min_count: float) -> torch.Tensor:
    """(M, W32) int32 planes + (N_pad, P) float32 phenotypes -> (M, P)
    float32 scores, on the planes' device."""
    if y_padded.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
    m, w32 = presence.shape
    out = torch.empty((m, y_padded.shape[1]), dtype=torch.float32,
                      device=y_padded.device)
    step = max(1, _SCORE_BLOCK_ELEMS // (32 * w32))
    for s in range(0, m, step):
        e = min(m, s + step)
        g = unpack_bits(presence[s:e]) + 0.5 * unpack_bits(het[s:e])
        yigi = g @ y_padded
        del g
        ysum = unpack_bits(nonmiss[s:e]) @ y_padded
        n, sg, sg2 = (v[s:e, None] for v in (total, s_gi, s_gi2))
        r = n * yigi - sg * ysum
        denom = n * (n * sg2 - sg * sg)
        score = torch.where(denom > 0, r * r / denom, 0.0)
        ok = (sg >= min_count) & ((n - sg) >= min_count)
        out[s:e] = torch.where(ok, score, 0.0)
    if out.is_cuda and recording():
        torch.cuda.synchronize(out.device)  # the span holds the device's work
    return out


def most_associated_snps(planes: SNPPlanes, phenotypes: np.ndarray,
                         n_best: int, maf: float, mac: float):
    """-> (list per phenotype column of row-sorted SNP indices of its
    top-n_best scores, the (M, P) float32 scores on the planes' device)."""
    dev = planes.presence.device
    n = planes.n_samples
    min_count = max(float(mac), math.ceil(maf * n))
    y = torch.zeros((planes.n_pad, phenotypes.shape[1]), dtype=torch.float32,
                    device=dev)
    y[:n] = torch.as_tensor(np.asarray(phenotypes, np.float32), device=dev)
    scores = snp_scores(planes.presence, planes.het, planes.nonmiss,
                        planes.s_gi, planes.s_gi2, planes.total, y,
                        min_count=min_count)
    with span("snp_topn"):
        k = min(n_best, scores.shape[0])
        top = torch.sort(scores.T, dim=1, descending=True,
                         stable=True).indices[:, :k]
        idx = torch.sort(top, dim=1).values.cpu().numpy()
    return list(idx), scores


def export_selected_snps(base_name: str, out_bases, snp_indices) -> None:
    """Copy selected rows of the original bed/bim into per-phenotype files,
    preserving the source's genotype bytes and bim lines. The bed body is
    mapped, not read whole."""
    names, m = formats.read_bed_header(base_name)
    body = np.memmap(base_name + ".bed", dtype=np.uint8, mode="r",
                     offset=len(formats.PLINK_BED_MAGIC),
                     shape=(m, (len(names) + 3) // 4))
    with open(base_name + ".bim") as f:
        bim_lines = f.read().splitlines()
    for out_base, idx in zip(out_bases, snp_indices):
        with open(out_base + ".bed", "wb") as f:
            f.write(formats.PLINK_BED_MAGIC)
            np.asarray(body[np.asarray(idx, np.int64)]).tofile(f)
        with open(out_base + ".bim", "w") as f:
            for i in idx:
                f.write(bim_lines[int(i)] + "\n")


def associate_snps(base_bedbim: str, pheno_accessions, pheno_values,
                   pheno_names, out_base: str, n_best: int,
                   maf: float, mac: float, *, device="cuda"):
    """The associate_snps flow: planes on `device`, every phenotype column
    scored, each column's top-N exported as bed/bim. Returns the
    per-column indices."""
    planes = load_bed_planes(base_bedbim, pheno_accessions,
                             device=require_device(device))
    idx, _ = most_associated_snps(planes, np.asarray(pheno_values,
                                                     np.float32),
                                  n_best, maf, mac)
    export_selected_snps(base_bedbim, [f"{out_base}.{nm}"
                                       for nm in pheno_names], idx)
    return idx
