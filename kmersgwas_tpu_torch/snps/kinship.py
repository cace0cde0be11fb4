"""EMMA kinship from a PLINK bed (port of kmersgwas_tpu/snps/kinship.py;
emma_kinship, src/emma_kinship.cpp:67-152).

Per SNP, two accumulation passes into K += g g' + (1-g)(1-g)':

  pass 1: het treated as 0; missing imputed with maf = #hom_alt / #observed
  pass 2: het treated as 1; missing imputed with maf = (#hom_alt + #het)/#observed

then the off-diagonals divided by 2 * (SNPs with any observed genotype)
and the diagonal set to 1.

Float64 on the device, over chunks of SNPs decoded there. The second
product is folded into the first: over R rows g,

  sum g g' + (1-g)(1-g)' = 2 A + R 11' - S 1' - 1 S',  A = sum g g',
  S = sum g,

so one (2c, n) x (2c, n) product a chunk takes the place of four. A SNP
with no observed genotype has g = 0 in both passes and is left out of R,
so it adds nothing, as the JAX package's filter drops it. The sums run in
another order than the JAX package's, so K agrees to rounding (the tests
hold it at atol 1e-12), not bit for bit.

Traced, the call is the span `snp_kinship`, holding per chunk `bed_read`
(the host's read), `bed_decode` (the upload, the decode and the two
imputed passes) and `snp_gram` (the product); counters
`snp_kinship.rows` (SNPs read), `.chunks`, `.bed_bytes` and `.used`
(SNPs with an observed call). The span ends on K's copy to the host, a
device sync, so it holds its device work.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import formats
from ..utils import count, require_device, span
from .bed import decode_dubits

# SNPs a chunk: the (2c, n) float64 operand is 1 GB at c = 2^16, n = 1008
KINSHIP_CHUNK = 1 << 15


@span("snp_kinship")
def emma_kinship_from_bed(base_name: str, chunk: int = KINSHIP_CHUNK, *,
                          device="cuda") -> np.ndarray:
    dev = require_device(device)
    names, m = formats.read_bed_header(base_name)
    n = len(names)
    f64 = torch.float64
    A = torch.zeros((n, n), dtype=f64, device=dev)
    S = torch.zeros(n, dtype=f64, device=dev)
    n_used = torch.zeros((), dtype=torch.int64, device=dev)
    chunks = formats.iter_bed_rows(base_name, chunk)
    for _ in range(-(-m // chunk)):
        with span("bed_read"):
            _, rows = next(chunks)
        with span("bed_decode"):
            d = decode_dubits(torch.from_numpy(rows).to(dev), n)
            hom, het, miss = d == 3, d == 2, d == 1
            total = (~miss).sum(1)
            n_used += (total > 0).sum()
            total = total.clamp_min(1).to(f64)[:, None]
            n_hom = hom.sum(1, keepdim=True).to(f64)
            g = torch.cat([
                torch.where(miss, n_hom / total, hom.to(f64)),
                torch.where(miss, (n_hom + het.sum(1, keepdim=True)) / total,
                            (hom | het).to(f64))])
        with span("snp_gram"):
            A += g.T @ g
            S += g.sum(0)
        count("snp_kinship.chunks")
        count("snp_kinship.bed_bytes", rows.nbytes)
    count("snp_kinship.rows", m)
    used = int(n_used)
    count("snp_kinship.used", used)
    r = 2 * used
    if r == 0:
        raise ValueError("no SNPs with observed genotypes")
    A = A + A.T                  # 2 A, exactly symmetric
    K = (A + r - (S[:, None] + S[None, :])) / r
    K.fill_diagonal_(1.0)
    return K.cpu().numpy()
