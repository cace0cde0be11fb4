"""EMMA kinship from the k-mers table as an exact integer Gram (port of
kmersgwas_tpu/ops/kinship.py).

Reference (src/kmers_multiple_databases.cpp:418-438 + emma_kinship_kmers.cpp):
for every MAC-passing k-mer row g, K[i][j] += 1 ^ g_i ^ g_j (an XNOR count),
then normalize by the number of k-mers used and set the diagonal to 1.

With the bits encoded as A in {-1, +1} int8,
    (A^T A)[i, j] = #match - #mismatch,   xnor_count = (n_rows + A^T A) / 2,
and int8 x int8 -> int32 products are exact, so the result matches the
reference's integer arithmetic bit for bit before the final float divide.
Padded sample lanes (0 bits, so -1) touch only padded rows and columns of
the Gram, which the accumulator slices away.

`kinship_accumulate` sends a CPU tensor to the plain version and a CUDA
tensor to the two kernels of csrc/kinship_gram.cu: `transpose_bits` (the
bit transpose, once per batch: the rows' bits sample-major, 128 rows a
chunk) and the Gram on int8 `wgmma` over the transposed bits. There is no
other route and no fallback. Each wrapper counts its calls
(`kinship_accumulate.launches`, `transpose_bits.launches`).

Traced (utils.span, utils.count): `kinship_accumulate` (K7: the transpose
and the Gram), the accumulator's `kinship_add`, `kinship_flush` and
`kinship_finalize`, and the counter `kinship.flushes`.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils import count, span
from . import _cuda
from .bitplanes import unpack_bits_pm1

# the device int32 partial is flushed into the host int64 total before it
# could overflow: each row adds at most 1 to any entry
SPILL_ROWS = 1 << 30
# rows per chunk of the transposed bits (csrc/kinship_gram.cu KC): one
# sample's bits of a chunk are 4 words
CHUNK_ROWS = 128


def _gram(a: torch.Tensor) -> torch.Tensor:
    """a^T a, int32, of an (rows, n_pad) int8 matrix: torch._int_mm on the
    card, an int32 product on the CPU (exact: every entry is at most
    rows <= 2^30 in magnitude, the accumulator's spill bound)."""
    if not a.is_cuda:
        a = a.to(torch.int32)
        return a.T @ a
    # _int_mm wants k (rows) a positive multiple of 8 (zero rows are
    # neutral: 0 * x = 0), m = n_pad > 16 and n = n_pad a multiple of 8
    # (n_pad is a multiple of 128), and its second operand contiguous
    pad = -a.shape[0] % 8 or (8 if a.shape[0] == 0 else 0)
    if pad:
        a = torch.nn.functional.pad(a, (0, 0, 0, pad))
    return torch._int_mm(a.T, a)


def kinship_gram_plain(packed: torch.Tensor, n_rows: int) -> torch.Tensor:
    """A^T A, (n_pad, n_pad) int32, over rows [0, n_rows) of (R, W32) int32
    planes: the +-1 unpack, then an exact integer product. The plain
    version of kinship_accumulate."""
    return _gram(unpack_bits_pm1(packed[:n_rows]))


def _chunks(n_rows: int) -> int:
    return -(-n_rows // CHUNK_ROWS)


def transpose_bits_plain(packed: torch.Tensor, n_rows: int) -> torch.Tensor:
    """The plain version of transpose_bits: out[c, s, q] holds, at bit b,
    sample s's bit of row c*CHUNK_ROWS + 32q + b (0 for rows >= n_rows)."""
    w32 = packed.shape[1]
    n_chunks = _chunks(n_rows)
    rows = torch.zeros((n_chunks * CHUNK_ROWS, w32), dtype=torch.int32,
                       device=packed.device)
    rows[:n_rows] = packed[:n_rows]
    rows = rows.view(n_chunks, CHUNK_ROWS // 32, 32, w32)
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    out = torch.zeros((n_chunks, CHUNK_ROWS // 32, w32 * 32),
                      dtype=torch.int32, device=packed.device)
    for b in range(32):
        bit = (rows[:, :, b, :, None] >> shifts) & 1
        out |= bit.reshape(out.shape) << b
    return out.transpose(1, 2).contiguous()


def transpose_bits(packed: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(R, W32) int32 planes -> (ceil(n_rows / 128), W32 * 32, 4) int32:
    the bits of rows [0, n_rows), sample-major, 128 rows a chunk (see
    transpose_bits_plain). A CUDA tensor launches the transpose kernel of
    csrc/kinship_gram.cu; a CPU tensor takes transpose_bits_plain."""
    rows, w32 = packed.shape
    if not 0 <= n_rows <= rows:
        raise ValueError(f"n_rows ({n_rows}) must be in [0, {rows}]")
    if packed.device.type == "cpu":
        return transpose_bits_plain(packed, n_rows)
    if packed.device.type != "cuda":
        raise ValueError(f"tensors on {packed.device} have no kernel")
    if packed.dtype != torch.int32 or not packed.is_contiguous() \
            or packed.data_ptr() % 16 or w32 % 4:
        raise ValueError("packed must be a contiguous, 16-byte aligned "
                         "(R, W32) int32 tensor with W32 a multiple of 4")
    out = torch.empty((_chunks(n_rows), w32 * 32, CHUNK_ROWS // 32),
                      dtype=torch.int32, device=packed.device)
    if n_rows == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(packed.device):
        rc = lib.lib.kgt_kinship_transpose(
            packed.data_ptr(), n_rows, w32, out.data_ptr(),
            torch.cuda.current_stream(packed.device).cuda_stream)
    _cuda.check(lib, rc, "kinship_transpose")
    transpose_bits.launches += 1
    return out


transpose_bits.launches = 0


@span("kinship_accumulate")
def kinship_accumulate(acc: torch.Tensor, packed: torch.Tensor,
                       n_rows: int | None = None) -> torch.Tensor:
    """acc (N_pad, N_pad) int32 += A^T A over rows [0, n_rows) of `packed`
    (R, W32) int32 planes (default: all R). Rows past n_rows contribute
    nothing, so a fixed-size staging buffer may carry a stale tail. On the
    card the batch's bits are transposed once (transpose_bits) and the
    kinship_gram kernel adds in place; returns acc."""
    rows, w32 = packed.shape
    n_rows = rows if n_rows is None else int(n_rows)
    if not 0 <= n_rows <= rows:
        raise ValueError(f"n_rows ({n_rows}) must be in [0, {rows}]")
    if acc.shape != (w32 * 32, w32 * 32) or acc.dtype != torch.int32:
        raise ValueError(f"acc must be a ({w32 * 32}, {w32 * 32}) int32 "
                         "tensor")
    if packed.device.type == "cpu" and acc.device.type == "cpu":
        acc += kinship_gram_plain(packed, n_rows)
        return acc
    for t in (packed, acc):
        if t.device.type != "cuda":
            raise ValueError(f"tensors on {t.device} have no kernel: CPU "
                             "tensors take the plain version, CUDA tensors "
                             "the kernel")
    if acc.device != packed.device or not acc.is_contiguous():
        raise ValueError("acc must be contiguous, on the planes' device")
    if packed.dtype != torch.int32 or not packed.is_contiguous() \
            or packed.data_ptr() % 16 or w32 % 4:
        raise ValueError("packed must be a contiguous, 16-byte aligned "
                         "(R, W32) int32 tensor with W32 a multiple of 4")
    if n_rows == 0:
        return acc
    dev = packed.device
    bits = transpose_bits(packed, n_rows)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.lib.kgt_kinship_gram(
            bits.data_ptr(), n_rows, w32, acc.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _cuda.check(lib, rc, "kinship_gram")
    kinship_accumulate.launches += 1
    return acc


kinship_accumulate.launches = 0


def kinship_accumulate_masked(acc: torch.Tensor, packed: torch.Tensor,
                              valid: torch.Tensor) -> torch.Tensor:
    """acc += A^T A where rows with valid == 0 contribute nothing
    (kmersgwas_tpu/ops/kinship.py:34-46), in place; returns acc. Under +-1
    an all-zero padding row is not neutral (it adds 1 to every pair), so
    invalid rows must be left out. On the CPU the plain version zeroes
    them (any mask). On the card the valid rows must be a prefix of the
    batch, as parallel/sharding.shard_batch pads shards: the kinship
    kernels then run over that prefix (kinship_accumulate with n_rows); a
    mask that is not a prefix raises (there is no plain Gram on the card).
    The card's path reads the mask on the host."""
    if packed.device.type == "cpu" and acc.device.type == "cpu":
        acc += _gram(unpack_bits_pm1(packed) * valid[:, None].to(torch.int8))
        return acc
    ok = valid.cpu() != 0
    n_rows = int(ok.sum())
    if not bool(ok[:n_rows].all()):
        raise ValueError("on the card the valid rows must be a prefix of "
                         "the batch")
    return kinship_accumulate(acc, packed, n_rows)


def kinship_init(n_pad: int, device) -> torch.Tensor:
    return torch.zeros((n_pad, n_pad), dtype=torch.int32, device=device)


class KinshipAccumulator:
    """Streaming accumulator: an int32 partial on each device, spilled into
    an int64 host total before it can overflow (port of kmersgwas_tpu/ops/
    kinship.py KinshipAccumulator and of kmersgwas_tpu/pipeline/
    kinship.py ShardedKinshipAccumulator).

    mesh: an optional parallel/sharding.Mesh (default: one shard on
    `device`). Each batch is cut into mesh.size contiguous row shards, as
    sharding.shard_batch cuts it, so a shard's valid rows are a prefix of
    it; each shard adds them into its own partial on its device
    (kinship_accumulate over that prefix: the kinship kernels on the
    card), with no exchange per batch. The partials meet in the host
    total at flush, so the matrix is the same for any shard count. Every
    partial is flushed before it could have taken SPILL_ROWS rows (the
    count of all rows added bounds every shard's)."""

    def __init__(self, n_used: int, n_pad: int, device=None, mesh=None):
        self.n_used = n_used
        self.n_pad = n_pad
        self.shard_devices = (tuple(mesh.devices) if mesh is not None
                              else (torch.device(device),))
        self.total = np.zeros((n_used, n_used), dtype=np.int64)
        self.device_accs = [kinship_init(n_pad, d)
                            for d in self.shard_devices]
        self.rows_in_acc = 0
        self.n_rows = 0

    @property
    def devices(self) -> list:
        """The partials' devices without repeats, in shard order."""
        return list(dict.fromkeys(self.shard_devices))

    @span("kinship_add")
    def add(self, packed_dev: torch.Tensor, n_rows: int | None = None) -> None:
        """Accumulate rows [0, n_rows) of a batch (default: all of it)."""
        rows = int(packed_dev.shape[0]) if n_rows is None else int(n_rows)
        if self.rows_in_acc + rows > SPILL_ROWS:
            self.flush()
        s = -(-int(packed_dev.shape[0]) // len(self.device_accs))
        for d, (acc, dev) in enumerate(zip(self.device_accs,
                                           self.shard_devices)):
            kinship_accumulate(acc, packed_dev[d * s:(d + 1) * s].to(dev),
                               min(max(rows - d * s, 0), s))
        self.rows_in_acc += rows
        self.n_rows += rows

    @span("kinship_flush")
    def flush(self) -> None:
        if self.rows_in_acc:
            count("kinship.flushes")
            part = sum(acc.cpu().numpy().astype(np.int64)
                       for acc in self.device_accs)
            self.total += part[: self.n_used, : self.n_used]
            for acc in self.device_accs:
                acc.zero_()
            self.rows_in_acc = 0

    @span("kinship_finalize")
    def finalize(self) -> np.ndarray:
        """Normalized kinship (N, N) float64, diagonal forced to 1
        (emma_kinship_kmers.cpp:95-102)."""
        self.flush()
        return normalize(self.total, self.n_rows)


def normalize(total: np.ndarray, n_rows: int) -> np.ndarray:
    """int64 sum of A^T A over n_rows rows -> the kinship matrix: the XNOR
    count (n_rows + total) / 2, over n_rows, in f64; diagonal 1."""
    if n_rows == 0:
        raise ValueError("no k-mers accumulated into kinship")
    xnor = (n_rows + total) / 2.0
    k = xnor / float(n_rows)
    np.fill_diagonal(k, 1.0)
    return k
