"""K7 (csrc/kinship_gram.cu) on the CPU: numpy mirrors of its two kernels,
step by step, against the port's plain versions and the JAX package.

- The bit transpose: a warp's five shuffle-and-mask stages, lane by lane,
  and the (chunk, sample, word) layout it writes, against
  `transpose_bits_plain` and `unpack_bits_pm1`.
- The Gram: the nibble expansion to +-1 bytes, B's core-matrix layout in
  shared memory read back through the descriptor's offsets, A's register
  fragments, the mask of the rows past n_rows, and the persistent
  schedule (equal contiguous spans of the pair-major (tile pair, chunk)
  list, an accumulator flushed when a block leaves a pair), against
  `kinship_gram_plain` and the JAX `kinship_accumulate`.

Everything is integer, so every comparison is exact. Inputs come from
numpy seeds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kmersgwas_tpu.ops import bitplanes as jbits
from kmersgwas_tpu.ops import kinship as jkin
from kmersgwas_tpu_torch.ops import bitplanes, kinship

KT = 128                 # tile side (csrc/kinship_gram.cu KT)
KC = kinship.CHUNK_ROWS  # rows per chunk (KC)
KW = KC // 32            # words of a sample per chunk
LBO, SBO = 128, 1024     # the B descriptor's offsets (hopper_async.cuh)
GRID = 2 * 132           # the kernel's grid: two blocks an SM, 132 SMs


def random_planes(seed, rows, n):
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    bits = np.zeros((rows, n_pad), np.uint8)
    bits[:, :n] = rng.integers(0, 2, size=(rows, n))
    return jbits.pack_bits_np(bits)


# ------------------------------------------------------------ transpose

def swap_blocks(x, k, m):
    """One stage of transpose32 on a (..., 32 lanes) uint32 array."""
    lane = np.arange(32)
    o = x[..., lane ^ k]
    m = np.uint32(m)
    up = (lane & k) != 0
    return np.where(up, (x & ~m) | ((o & ~m) >> np.uint32(k)),
                    (x & m) | ((o & m) << np.uint32(k)))


def transpose32(x):
    for k, m in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                 (2, 0x33333333), (1, 0x55555555)):
        x = swap_blocks(x, k, m)
    return x


def transpose_kernel(packed, n_rows):
    """kinship_transpose_kernel: the block stages the chunk's rows (0 past
    n_rows); the warp of word column wc reads word wc of rows
    c*KC + 32q + lane, transposes each 32-row group, and lane j stores
    sample 32wc + j's 4 words."""
    rows, w32 = packed.shape
    n_chunks = -(-n_rows // KC)
    x = np.zeros((n_chunks * KC, w32), np.uint32)
    x[:n_rows] = packed[:n_rows]
    x = x.reshape(n_chunks, KW, 32, w32).transpose(0, 1, 3, 2)  # lanes last
    y = transpose32(x)                          # (c, q, wc, lane)
    return y.transpose(0, 2, 3, 1).reshape(n_chunks, w32 * 32, KW)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_transpose32_is_a_bit_transpose(seed):
    x = np.random.default_rng(seed).integers(
        0, 2 ** 32, size=(5, 32), dtype=np.uint64).astype(np.uint32)
    y = transpose32(x)
    bx = (x[..., None] >> np.arange(32, dtype=np.uint32)) & 1   # [lane][bit]
    by = (y[..., None] >> np.arange(32, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(by, bx.transpose(0, 2, 1))


@pytest.mark.parametrize("n,rows,n_rows", [
    (100, 300, 263), (300, 300, 77), (1008, 300, 300), (1008, 256, 256)])
def test_transposed_layout_matches_plain_and_unpack(n, rows, n_rows):
    """n_pad 128, 384 and 1024; a ragged last chunk, n_rows below one
    chunk, whole chunks. Bits of rows past n_rows are 0."""
    packed = random_planes(n + rows, rows, n)
    got = transpose_kernel(packed, n_rows)
    plain = kinship.transpose_bits_plain(bitplanes.as_planes(packed), n_rows)
    np.testing.assert_array_equal(got.view(np.int32), plain.numpy())
    # bit b of word q of sample s in chunk c is row c*KC + 32q + b
    b = (got[..., None] >> np.arange(32, dtype=np.uint32)) & 1  # c, s, q, b
    g = b.transpose(0, 2, 3, 1).reshape(-1, got.shape[1])
    pm1 = bitplanes.unpack_bits_pm1(bitplanes.as_planes(packed)).numpy()
    np.testing.assert_array_equal(g[:n_rows],
                                  (pm1[:n_rows] > 0).astype(g.dtype))
    assert not g[n_rows:].any()


# ----------------------------------------------------------------- Gram

def nib01(x):
    return ((x & np.uint32(0xF)) * np.uint32(0x00204081)) \
        & np.uint32(0x01010101)


def nib_pm1(x):
    return ~(nib01(x) * np.uint32(0xFE))


def int8_bytes(words):
    """(..., m) uint32 -> (..., 4m) int8, little-endian bytes."""
    return np.ascontiguousarray(words, np.uint32).view(np.int8)


def test_nibble_expansion():
    x = np.arange(16, dtype=np.uint32)
    bits = (x[:, None] >> np.arange(4, dtype=np.uint32)) & 1
    np.testing.assert_array_equal(int8_bytes(nib01(x)[:, None]), bits)
    np.testing.assert_array_equal(int8_bytes(nib_pm1(x)[:, None]),
                                  2 * bits.astype(np.int8) - 1)
    # the mask of valid rows: 0xFF per valid byte
    np.testing.assert_array_equal(
        int8_bytes((nib01(x) * np.uint32(0xFF))[:, None]), -bits.astype(
            np.int8))
    # bits above the nibble do not leak in
    np.testing.assert_array_equal(nib01(x | np.uint32(0xFFFFFFF0)),
                                  nib01(x))


def expand_b(jbits):
    """The block's B expansion: (128 samples, KW words) of bits -> the
    16 KB shared-memory buffer, thread (sb, hb) storing words 2hb and
    2hb + 1 of sample sb as two 16-byte rows each."""
    smem = np.zeros(KT * KC, np.int8)
    for sb in range(KT):
        for hb in range(2):
            for e in range(2):
                x = jbits[sb, 2 * hb + e]
                k16 = 2 * (2 * hb + e)
                off = ((sb >> 3) * (KC // 16) + k16) * 128 + (sb & 7) * 16
                sh = np.arange(0, 32, 4, dtype=np.uint32)
                smem[off:off + 16] = int8_bytes(nib_pm1(x >> sh[:4]))
                smem[off + 128:off + 144] = int8_bytes(nib_pm1(x >> sh[4:]))
    return smem


def read_b(smem):
    """B (KC rows k x KT samples n) as wgmma reads it: k32 step ks from the
    descriptor at ks*256, core matrix (n // 8, (k % 32) // 16) at SBO and
    LBO apart, row n % 8 of 16 bytes."""
    k = np.arange(KC)[:, None]
    n = np.arange(KT)[None, :]
    addr = (k // 32) * 256 + (n // 8) * SBO + ((k % 32) // 16) * LBO \
        + (n % 8) * 16 + k % 16
    return smem[addr]


def build_a(ibits, left):
    """A (KT samples i x KC rows k) from the threads' register fragments:
    warp w, lane (g, t) holds rows ra = 16w + g and ra + 8, bytes 4t.. and
    16 + 4t.. of each k32 step; bytes of rows >= left are 0x00."""
    a = np.zeros((KT, KC), np.int8)
    for w in range(8):
        for lane in range(32):
            g, t = lane >> 2, lane & 3
            ra = 16 * w + g
            sh = np.uint32(4 * t)
            for ks in range(KW):
                xa, xb = ibits[ra, ks], ibits[ra + 8, ks]
                frag = np.array([nib_pm1(xa >> sh), nib_pm1(xb >> sh),
                                 nib_pm1(xa >> (sh + np.uint32(16))),
                                 nib_pm1(xb >> (sh + np.uint32(16)))],
                                np.uint32)
                if left < KC:
                    v = left - 32 * ks
                    vm = np.uint32(0xFFFFFFFF if v >= 32 else 0 if v <= 0
                                   else (1 << v) - 1)
                    m0 = nib01(vm >> sh) * np.uint32(0xFF)
                    m1 = nib01(vm >> (sh + np.uint32(16))) * np.uint32(0xFF)
                    frag &= np.array([m0, m0, m1, m1], np.uint32)
                by = int8_bytes(frag).reshape(4, 4)
                k0 = 32 * ks + 4 * t
                a[ra, k0:k0 + 4] = by[0]
                a[ra + 8, k0:k0 + 4] = by[1]
                a[ra, k0 + 16:k0 + 20] = by[2]
                a[ra + 8, k0 + 16:k0 + 20] = by[3]
    return a


def pair_of(item, n_chunks, n_tiles):
    """The Cursor's decode: pair-major items, pairs (bi <= bj) row by row."""
    pair, chunk = divmod(item, n_chunks)
    bi = 0
    while pair >= n_tiles - bi:
        pair -= n_tiles - bi
        bi += 1
    return bi, bi + pair, chunk


def spans(n_items, grid):
    return [(n_items * b // grid, n_items * (b + 1) // grid)
            for b in range(grid)]


def schedule(n_tiles, n_chunks, grid):
    """-> per block, its list of (bi, bj, chunk, flush after this item),
    walked as the kernel's two cursors walk it."""
    n_items = n_tiles * (n_tiles + 1) // 2 * n_chunks
    out = []
    for it0, it1 in spans(n_items, grid):
        items = []
        if it0 < it1:
            bi, bj, chunk = pair_of(it0, n_chunks, n_tiles)
            for k in range(it1 - it0):
                last = k + 1 == it1 - it0 or chunk + 1 == n_chunks
                items.append((bi, bj, chunk, last))
                chunk += 1                   # Cursor::advance
                if chunk == n_chunks:
                    chunk = 0
                    bj += 1
                    if bj == n_tiles:
                        bi += 1
                        bj = bi
        out.append(items)
    return out


@pytest.mark.parametrize("n_tiles,n_chunks,grid", [
    (1, 1, GRID), (1, 300, GRID), (2, 5, 4), (3, 7, 5), (8, 2, GRID),
    (8, 8192, GRID), (8, 3, 7), (4, 1, 3)])
def test_schedule_covers_every_item_once(n_tiles, n_chunks, grid):
    """Every (pair, chunk) exactly once, spans within one item of equal,
    a flush at every pair boundary and span end, and blocks without work
    when there are more blocks than items."""
    blocks = schedule(n_tiles, n_chunks, grid)
    n_items = n_tiles * (n_tiles + 1) // 2 * n_chunks
    seen = [(bi, bj, c) for items in blocks for bi, bj, c, _ in items]
    want = [(bi, bj, c) for bi in range(n_tiles) for bj in range(bi, n_tiles)
            for c in range(n_chunks)]
    assert seen == want
    lens = [len(items) for items in blocks]
    assert max(lens) - min(lens) <= 1 and sum(lens) == n_items
    for items in blocks:
        for (bi, bj, c, last), nxt in zip(items, items[1:] + [None]):
            assert last == (nxt is None or (nxt[0], nxt[1]) != (bi, bj))
    flushes = sum(last for items in blocks for *_, last in items)
    # each block flushes once per pair it touches
    assert flushes == sum(len({(bi, bj) for bi, bj, _, _ in items})
                          for items in blocks)


def gram_kernel(bits, n_rows, n_pad, grid):
    """kinship_gram_kernel over the transposed bits: per block, per item,
    B expanded and read through the descriptor, A from fragments, the
    int32 products; a flush adds the accumulator to acc[I][J] and, off
    the diagonal, its transpose to acc[J][I]."""
    n_tiles = n_pad // KT
    n_chunks = bits.shape[0]
    acc = np.zeros((n_pad, n_pad), np.int64)
    for items in schedule(n_tiles, n_chunks, grid):
        d = np.zeros((KT, KT), np.int64)
        for bi, bj, chunk, last in items:
            tile_i = bits[chunk, bi * KT:(bi + 1) * KT]
            tile_j = bits[chunk, bj * KT:(bj + 1) * KT]
            b = read_b(expand_b(tile_j)).astype(np.int64)
            a = build_a(tile_i, n_rows - chunk * KC).astype(np.int64)
            d += a @ b
            if last:
                acc[bi * KT:(bi + 1) * KT, bj * KT:(bj + 1) * KT] += d
                if bi != bj:
                    acc[bj * KT:(bj + 1) * KT, bi * KT:(bi + 1) * KT] += d.T
                d[:] = 0
    return acc


@pytest.mark.parametrize("n,rows,n_rows,grid", [
    (100, 300, 263, GRID), (100, 300, 263, 2), (300, 300, 77, 4),
    (300, 200, 200, GRID), (1008, 300, 300, 7), (1008, 150, 129, GRID)])
def test_gram_mirror_matches_plain_and_jax(n, rows, n_rows, grid):
    """n_pad 128, 384, 1024; ragged n_rows (the rows past it random: they
    must add nothing), n_rows below one chunk, more blocks than items,
    spans that cross pairs."""
    packed = random_planes(3 * n + n_rows, rows, n)
    bits = transpose_kernel(packed, n_rows)
    n_pad = packed.shape[1] * 32
    got = gram_kernel(bits, n_rows, n_pad, grid)
    plain = kinship.kinship_gram_plain(bitplanes.as_planes(packed), n_rows)
    np.testing.assert_array_equal(got, plain.numpy())
    acc0 = np.zeros((n_pad, n_pad), np.int32)
    want = np.asarray(jkin.kinship_accumulate(jnp.asarray(acc0),
                                              jnp.asarray(packed[:n_rows])))
    np.testing.assert_array_equal(got, want)


def test_transpose_wrapper_refusals():
    packed = bitplanes.as_planes(random_planes(0, 40, 100))
    with pytest.raises(ValueError, match="n_rows"):
        kinship.transpose_bits(packed, 41)
    launches = kinship.transpose_bits.launches
    out = kinship.transpose_bits(packed, 0)
    assert out.shape == (0, 128, 4)
    assert kinship.transpose_bits.launches == launches    # CPU: plain
