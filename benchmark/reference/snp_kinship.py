"""The EMMA kinship of a PLINK bed as voichek/kmersGWAS computes it
(src/emma_kinship.cpp:67-152), in plain PyTorch from the bed's own bytes.

Per SNP, over all n samples of the fam, two passes:

  pass 1: g = 1 for a homozygous call of the bim's second allele, 0 for
          any other observed call (het as 0); a missing call imputed with
          the pass's frequency, #hom / #observed
  pass 2: g = 1 for a homozygous or heterozygous call (het as 1), 0 for
          the other homozygote; a missing call imputed with
          (#hom + #het) / #observed

and each pass adds the two products g g' and (1 - g)(1 - g)' to K, as the
C++ does (`:45-52`), each written out: no fold of the four into one. Then
the off-diagonal is divided by 2 x (the SNPs used) and the diagonal set
to 1.

Departures from the C++:
- A SNP with no observed call is dropped, from the products and from the
  count that divides them, as the JAX package drops it (the C++ divides
  0 by 0 for its frequency, and its NaN would reach every entry).
- The products are matrix products over blocks of SNPs, so the sums run
  in another order than the C++'s loop over SNPs: float64 rounding, not
  bit for bit.
- TF32 is off, so a float32 product on the card is float32 (the
  control's precision; the configuration's is float64).
"""
from __future__ import annotations

import numpy as np
import torch

from .bedfile import unpack

F64 = torch.float64
BLOCK = 1 << 15


def emma_kinship(rows: np.ndarray, n_fam: int, device, *,
                 dtype: torch.dtype = F64,
                 block: int = BLOCK) -> torch.Tensor:
    """(M, ceil(n_fam / 4)) uint8 bed rows (a memmap will do) -> the
    (n_fam, n_fam) kinship on `device`, held in float64, computed in
    blocks of `block` SNPs with products and sums in `dtype`: float64 is
    the configuration's precision, float32 the control's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    k = torch.zeros((n_fam, n_fam), dtype=dtype, device=device)
    used = 0
    for s in range(0, rows.shape[0], block):
        b = torch.from_numpy(np.array(rows[s:s + block]))
        d = unpack(b.to(device), n_fam)
        obs = d != 1
        total = obs.sum(dim=1)
        keep = total > 0
        d, obs = d[keep], obs[keep]
        total = total[keep].to(dtype)[:, None]
        used += int(keep.sum())
        hom, het = d == 3, d == 2
        for called in (hom, hom | het):
            freq = called.sum(dim=1, keepdim=True).to(dtype) / total
            g = torch.where(obs, called.to(dtype), freq)
            h = 1 - g
            k += g.T @ g
            k += h.T @ h
    if used == 0:
        raise ValueError("no SNPs with observed genotypes")
    k = k / (2 * used)
    k.fill_diagonal_(1.0)
    return k.to(F64)
