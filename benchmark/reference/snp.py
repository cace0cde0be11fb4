"""The GRAMMAR-Gamma SNP score of voichek/kmersGWAS in float64, from the
bed's own bytes, and the control's selection of each column's top SNPs.

For a SNP, over the used samples whose call is observed (a missing call is
left out of every sum), with doses g_i of 0, 1/2 (heterozygous) or 1
(homozygous for the bim's second allele), and a phenotype column y
(src/snps_multiple_databases.cpp:157-172):

    N    = the observed samples       S_gi  = sum g_i     S_gi2 = sum g_i^2
    yigi = sum y_i g_i                ysum  = sum y_i
    score = (N yigi - S_gi ysum)^2 / (N (N S_gi2 - S_gi^2))

0 where the denominator is not above 0, and 0 where S_gi < min_count or
N - S_gi < min_count (min_count = max(mac, ceil(maf N_used)), N_used the
samples used, associate_snps.cpp).
"""
from __future__ import annotations

import numpy as np
import torch

from .bedfile import unpack
from .scan import min_count  # noqa: F401 (the same rule as the k-mer scan)

F64 = torch.float64


def scores64(rows: np.ndarray, cols: torch.Tensor, n_fam: int,
             y64: torch.Tensor, mc: float,
             block: int = 1 << 16) -> torch.Tensor:
    """(M, ceil(n_fam / 4)) uint8 bed rows (a memmap will do), the used
    samples' positions in the fam (n_used,) int64 and their (n_used, P)
    float64 phenotypes -> (M, P) float64 scores on the phenotypes' device,
    in blocks of `block` SNPs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = torch.empty((rows.shape[0], y64.shape[1]), dtype=F64,
                      device=y64.device)
    for s in range(0, rows.shape[0], block):
        b = torch.from_numpy(np.array(rows[s:s + block]))
        d = unpack(b.to(y64.device), n_fam)[:, cols]
        obs = (d != 1).to(F64)
        g = (d == 3).to(F64) + 0.5 * (d == 2).to(F64)
        n = obs.sum(dim=1, keepdim=True)
        sg = g.sum(dim=1, keepdim=True)
        sg2 = (g * g).sum(dim=1, keepdim=True)
        r = n * (g @ y64) - sg * (obs @ y64)
        denom = n * (n * sg2 - sg * sg)
        sc = torch.where(denom > 0, r * r / denom, torch.zeros_like(r))
        ok = (sg >= mc) & (n - sg >= mc)
        out[s:s + block] = torch.where(ok, sc, torch.zeros_like(sc))
    return out


def to_tf32_values(y: torch.Tensor) -> torch.Tensor:
    """float32 y rounded to TF32's 10-bit mantissa, to nearest, ties away
    from zero (cvt.rna.tf32.f32), held in float32: the control's
    precision, the one below float32."""
    b = y.to(torch.float32).contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def top_rows(s: torch.Tensor, k: int) -> torch.Tensor:
    """(M, P) scores -> (P, k) int64 rows of each column's k highest, the
    lower row first on equal scores, in ascending row order."""
    top = torch.sort(s.T, dim=1, descending=True, stable=True).indices
    return torch.sort(top[:, :k], dim=1).values
