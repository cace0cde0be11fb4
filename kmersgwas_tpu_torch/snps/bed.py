"""PLINK bed genotypes into bit-planes on the device (port of
kmersgwas_tpu/snps/bed.py; MultipleSNPsDataBases' constructor,
src/snps_multiple_databases.cpp:69-150).

A .bed for a named sample subset becomes three packed planes per SNP

  presence  - dubit 11 (homozygous alt)         -> bit 1
  nonmiss   - dubit != 01 (genotype observed)    -> bit 1
  het       - dubit 10 (heterozygous)            -> bit 1

(LSB-first uint32 words, samples padded to LANE_PAD with 0 bits, held as
the int32 view of those words, as ops/bitplanes does) and per-SNP
scalars: S_gi (alt dose, het = 1/2), S_gi^2 and the observed count N.

The JAX package decodes the whole bed into an (M, n) dubit matrix on the
host. Here the bed streams in chunks of SNPs: each chunk's bytes go to
the device, which decodes, reorders, counts and packs them, so neither
the host nor the device ever holds the (M, n) matrix. The scalars come
from integer counts: the JAX package's float64 sums of multiples of 1/4,
cast to float32, are exact, and so are these.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..core import formats
from ..core.table import LANE_PAD
from ..utils import count, recording, require_device, span

# SNPs a chunk: 2^16 x 1008 samples is 64 MB of dubits on the device
BED_CHUNK = 1 << 16


@dataclass
class SNPPlanes:
    presence: torch.Tensor   # (M, W32) int32 view of the uint32 planes
    nonmiss: torch.Tensor    # (M, W32)
    het: torch.Tensor        # (M, W32)
    s_gi: torch.Tensor       # (M,) float32 sum of doses (het counts 1/2)
    s_gi2: torch.Tensor      # (M,) float32 sum of squared doses
    total: torch.Tensor      # (M,) float32 observed samples
    n_samples: int
    n_pad: int


def decode_dubits(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(c, ceil(n/4)) uint8 bed bytes -> (c, n) uint8 dubits in {0..3}."""
    shifts = torch.arange(0, 8, 2, dtype=torch.uint8, device=rows.device)
    return ((rows[..., None] >> shifts) & 3).reshape(rows.shape[0], -1)[:, :n]


def pack_rows(bits: torch.Tensor, n_pad: int) -> torch.Tensor:
    """(c, n) bool -> (c, n_pad / 32) int32 planes, LSB-first, 0-padded."""
    c, n = bits.shape
    padded = torch.zeros((c, n_pad), dtype=torch.uint8, device=bits.device)
    padded[:, :n] = bits
    weights = torch.tensor([1 << b for b in range(8)], dtype=torch.uint8,
                           device=bits.device)
    by = (padded.view(c, n_pad // 8, 8) * weights).sum(-1).to(torch.uint8)
    return by.view(torch.int32)          # little-endian bytes -> words


def sample_order(fam_names, samples_to_use):
    """Positions of `samples_to_use` in the .fam (all samples when None)
    -> (positions, number used); the JAX package's error for a sample
    missing from the .fam."""
    if samples_to_use is None:
        return np.arange(len(fam_names)), len(fam_names)
    pos = {nm: i for i, nm in enumerate(fam_names)}
    try:
        order = np.array([pos[nm] for nm in samples_to_use], dtype=np.int64)
    except KeyError as e:
        raise ValueError(f"sample missing from fam file: {e.args[0]}") \
            from None
    return order, len(order)


@span("snp_load_planes")
def load_bed_planes(base_name: str, samples_to_use=None, *,
                    device="cuda", chunk: int = BED_CHUNK) -> SNPPlanes:
    dev = require_device(device)
    fam_names, m = formats.read_bed_header(base_name)
    order, n = sample_order(fam_names, samples_to_use)
    n_pad = ((n + LANE_PAD - 1) // LANE_PAD) * LANE_PAD
    cols = torch.as_tensor(order, device=dev)
    planes = [torch.empty((m, n_pad // 32), dtype=torch.int32, device=dev)
              for _ in range(3)]
    counts = torch.empty((3, m), dtype=torch.int64, device=dev)
    chunks = formats.iter_bed_rows(base_name, chunk)
    for _ in range(-(-m // chunk)):
        with span("bed_read"):
            s, rows = next(chunks)
        with span("bed_decode"):
            d = decode_dubits(torch.from_numpy(rows).to(dev),
                              len(fam_names))[:, cols]
            e = s + d.shape[0]
            for i, bits in enumerate((d == 3, d != 1, d == 2)):
                planes[i][s:e] = pack_rows(bits, n_pad)
                counts[i, s:e] = bits.sum(1)
        count("snp.chunks")
        count("snp.bed_bytes", rows.nbytes)
    count("snp.rows", m)
    hom, obs, het = counts.to(torch.float64)
    out = SNPPlanes(
        presence=planes[0], nonmiss=planes[1], het=planes[2],
        s_gi=(hom + 0.5 * het).to(torch.float32),
        s_gi2=(hom + 0.25 * het).to(torch.float32),
        total=obs.to(torch.float32), n_samples=n, n_pad=n_pad)
    if dev.type == "cuda" and recording():
        torch.cuda.synchronize(dev)     # the span holds the device's work
    return out
