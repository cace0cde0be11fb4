"""The inputs of a run, all made from its seed: the phenotype columns, the
generator's key, and the k-mers `.table` of the table cells.

Every input is a pure function of (seed, the cell's sizes). Each use draws
from its own stream, keyed by a hash of the seed and a tag.
"""
from __future__ import annotations

import hashlib
import os

import numpy as np
import torch

from . import gen
from .reference.tablefile import TableWriter, row_words

CHUNK = 1 << 20


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed of the stream `tag` of run `seed`."""
    d = hashlib.blake2b(f"{seed}:{tag}".encode(), digest_size=8).digest()
    return int.from_bytes(d, "little") >> 1


def generator(seed: int, tag: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(subseed(seed, tag))
    return g


def lanes_w32(n: int) -> int:
    """Words of 32 lanes for n samples, padded to 128 lanes (the port's
    lane padding, core/table.py LANE_PAD)."""
    return -(-n // 128) * 4


def phenotypes(n: int, p: int, seed: int, device) -> np.ndarray:
    """(n, p) float32: a Gaussian phenotype and p - 1 permutations of it
    (the reference's one phenotype plus permutations)."""
    g = generator(seed, "phenotypes", device)
    y0 = torch.randn(n, generator=g, device=device)
    perm = torch.rand((p - 1, n), generator=g, device=device).argsort(dim=1)
    y = torch.cat([y0[None], y0[perm]]).T
    return y.contiguous().cpu().numpy()


def used_mask(n: int, w32: int, device) -> torch.Tensor:
    """(w32,) int32 masks keeping the first n lanes of a row's words."""
    valid = (n - 32 * torch.arange(w32, device=device)).clamp(0, 32)
    m = torch.where(valid == 32, torch.full_like(valid, -1),
                    (1 << valid) - 1)
    return m.to(torch.int32)


def write_table(base: str, n: int, rows: int, kmer_len: int, seed: int,
                device) -> None:
    """A `.table` of `rows` rows over n accessions (acc0 ...): strictly
    increasing k-mer codes below 2^62, uniform presence bits from the
    benchmark's generator, the bits past n zero; and its `.names`."""
    wf = row_words(n)
    gw = -(-2 * wf // 4) * 4
    key = subseed(seed, "table")
    g = generator(seed, "codes", device)
    mask = used_mask(n, 2 * wf, device)
    code0 = 0
    with TableWriter(base, [f"acc{i}" for i in range(n)], kmer_len) as tw:
        for c, s in enumerate(range(0, rows, CHUNK)):
            m = min(CHUNK, rows - s)
            planes = gen.gen_planes(m, gw, key, c, device, popcount=False)
            words = (planes[:, :2 * wf] & mask).contiguous()
            gaps = torch.randint(1, 1 << 36, (m,), generator=g,
                                 device=device)
            codes = code0 + torch.cumsum(gaps, 0)
            code0 = int(codes[-1])
            tw.append(codes.cpu().numpy().astype(np.uint64),
                      words.cpu().numpy().view(np.uint64))


def fresh_dir(path: str) -> str:
    """An emptied directory at a fixed path (a run's table and the
    program's dtable of the run before it are removed first)."""
    os.makedirs(path, exist_ok=True)
    for f in os.listdir(path):
        os.remove(os.path.join(path, f))
    return path
