"""The PLINK 1 binary genotype format (`.bed`, `.bim`, `.fam`), written and
read without the port (PLINK 1.9's file format description; the format
kmersGWAS reads in src/snps_multiple_databases.cpp:69-150).

`<base>.bed`: the magic bytes 6C 1B 01 (SNP-major), then one row of
ceil(n / 4) bytes a SNP, sample j in bits 2 (j % 4) and 2 (j % 4) + 1 of
byte j // 4 (the dubit), the bits past the last sample 0. A dubit is 0
homozygous for the bim's first allele, 1 missing, 2 heterozygous, 3
homozygous for the second allele. `<base>.fam`: one sample a line, family
and individual id first. `<base>.bim`: one SNP a line: chromosome, id,
genetic distance, position, first allele, second allele, tab-separated.
"""
from __future__ import annotations

import numpy as np
import torch

MAGIC = bytes([0x6C, 0x1B, 0x01])
# chromosomes of the bim; the SNPs are spread over them in order
CHROMOSOMES = 5
# a bim line: "<chromosome>\tsnp<8 digits>\t0\t<9 digits>\tA\tG\n"
_BIM = np.frombuffer(b"1\tsnp00000000\t0\t000000000\tA\tG\n", np.uint8)
_ID_AT, _POS_AT = 5, 16


def row_bytes(n_samples: int) -> int:
    return (n_samples + 3) // 4


def pack(dubits: torch.Tensor) -> torch.Tensor:
    """(c, n) uint8 dubits -> (c, ceil(n / 4)) uint8 bed rows."""
    c, n = dubits.shape
    q = torch.zeros((c, 4 * row_bytes(n)), dtype=torch.uint8,
                    device=dubits.device)
    q[:, :n] = dubits
    q = q.view(c, -1, 4)
    return q[..., 0] | (q[..., 1] << 2) | (q[..., 2] << 4) | (q[..., 3] << 6)


def unpack(rows: torch.Tensor, n: int) -> torch.Tensor:
    """(c, ceil(n / 4)) uint8 bed rows -> (c, n) uint8 dubits."""
    shifts = torch.tensor([0, 2, 4, 6], dtype=torch.uint8,
                          device=rows.device)
    return ((rows[:, :, None] >> shifts) & 3).reshape(rows.shape[0],
                                                      -1)[:, :n]


def _digits(v: np.ndarray, width: int) -> np.ndarray:
    """(c,) non-negative integers -> (c, width) ASCII decimal digits."""
    p = 10 ** np.arange(width - 1, -1, -1, dtype=np.int64)
    return (v[:, None] // p % 10 + ord("0")).astype(np.uint8)


def bim_lines(start: int, stop: int, m: int) -> bytes:
    """The bim lines of SNPs start:stop of m: ids snp<i>, the SNPs spread
    evenly over the chromosomes in order, 20 bp apart."""
    i = np.arange(start, stop, dtype=np.int64)
    per = -(-m // CHROMOSOMES)
    out = np.tile(_BIM, (len(i), 1))
    out[:, 0] = ord("1") + i // per
    out[:, _ID_AT:_ID_AT + 8] = _digits(i, 8)
    out[:, _POS_AT:_POS_AT + 9] = _digits(1 + 20 * (i % per), 9)
    return out.tobytes()


class BedWriter:
    """Append SNP rows to a new `<base>.bed`, its `<base>.bim` alongside,
    and write `<base>.fam` for the samples `names`, in that order."""

    def __init__(self, base: str, names, n_snps: int):
        self.n, self.m, self.done = len(names), n_snps, 0
        with open(base + ".fam", "w") as f:
            f.write("".join(f"{nm} {nm} 0 0 0 -9\n" for nm in names))
        self.bed = open(base + ".bed", "wb")
        self.bed.write(MAGIC)
        self.bim = open(base + ".bim", "wb")

    def append(self, dubits: torch.Tensor) -> None:
        """(c, n) uint8 dubits of the next c SNPs."""
        pack(dubits).cpu().numpy().tofile(self.bed)
        self.bim.write(bim_lines(self.done, self.done + dubits.shape[0],
                                 self.m))
        self.done += dubits.shape[0]

    def close(self) -> None:
        self.bed.close()
        self.bim.close()
        if self.done != self.m:
            raise ValueError(f"{self.done} SNPs written, {self.m} declared")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def read_fam(base: str) -> list:
    """The samples of `<base>.fam`, by individual id, in file order."""
    with open(base + ".fam") as f:
        return [ln.split()[1] for ln in f if ln.strip()]


def read_bed(base: str):
    """-> (sample names, (M, ceil(n / 4)) uint8 memmap of the bed rows)."""
    names = read_fam(base)
    with open(base + ".bed", "rb") as f:
        if f.read(3) != MAGIC:
            raise ValueError(f"{base}.bed: not a SNP-major PLINK bed")
    rows = np.memmap(base + ".bed", dtype=np.uint8, mode="r",
                     offset=len(MAGIC))
    return names, rows.reshape(-1, row_bytes(len(names)))
