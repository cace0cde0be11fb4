"""K6's grid walk (kmersgwas_tpu_torch/csrc/gen_planes.cu) emulated on the
CPU: the blocks of the grid, the chunks of 32 rows each warp takes with a
fixed stride, each lane's (row, Philox block) items and store addresses, and
the popcount gather (the w32 = 32 kernel's reduce-scatter of shuffles, the
generic kernel's shared counts), with the Philox counters the kernel forms.

Every (row, block) of the batch is written exactly once, at its own
address, and nothing else is written; pc[r] sums exactly row r's blocks;
the emulated planes and popcounts equal gen_planes_plain, for ragged row
counts and w32 in {4, 12, 32, 64, 128}, on a full grid and on one small
enough that each warp walks many chunks. The kernel itself is held to the
plain version on the card (tests/test_torch_gpu.py, chip_smoke.py)."""
import numpy as np
import pytest
import torch

from kmersgwas_tpu_torch.ops import gen

GEN_THREADS = 256
GEN_WARPS = GEN_THREADS // 32
LANES = np.arange(32)
M32 = 0xFFFFFFFF
BYTE_POPC = np.array([bin(i).count("1") for i in range(256)], np.int64)


def grid_blocks(rows, sms, per_sm):
    """gen_grid: the blocks the chunks need, at most sms * per_sm."""
    need = (-(-rows // 32) + GEN_WARPS - 1) // GEN_WARPS
    return min(need, sms * per_sm)


def warp_chunks(rows, blocks):
    """(warp, chunk) pairs in the kernel's order: warp w of the grid takes
    chunks w, w + W, w + 2W, ... (W warps in the grid)."""
    chunks, n_warps = -(-rows // 32), blocks * GEN_WARPS
    for w in range(n_warps):
        for c in range(w, chunks, n_warps):
            yield w, c


def lane_items(nb):
    """(k, lane) -> (row in the chunk, block), (nb, 32) each, as the kernel
    walks them: w32 = 32 by shifts, other widths by the carry walk."""
    if nb == 8:
        k = np.arange(8)[:, None]
        return 4 * k + (LANES >> 3)[None, :], np.broadcast_to(LANES & 7,
                                                              (8, 32))
    step_r, step_b = 32 // nb, 32 % nb
    rr, bb = LANES // nb, LANES % nb          # the one division, per thread
    rows, blocks = [], []
    for _ in range(nb):
        rows.append(rr.copy())
        blocks.append(bb.copy())
        rr, bb = rr + step_r, bb + step_b
        carry = bb >= nb
        bb, rr = np.where(carry, bb - nb, bb), np.where(carry, rr + 1, rr)
    return np.stack(rows), np.stack(blocks)


def popc4(words):
    """(..., 4) int64 words in [0, 2^32) -> (...,) set-bit counts."""
    b = words.astype(np.uint32).view(np.uint8).reshape(*words.shape[:-1], 16)
    return BYTE_POPC[b].sum(axis=-1)


def reduce_scatter(cnt):
    """The w32 = 32 kernel's popcount gather: cnt (8, 32) block counts of
    item k of lane l (row 4k + l / 8) -> (32,) lane i's row-i count."""
    cnt = [c.copy() for c in cnt]
    for s, n in ((0, 8), (1, 4), (2, 2)):
        hi = (LANES >> s) & 1 == 1
        partner = LANES ^ (1 << s)
        half = n // 2
        new = []
        for m in range(half):
            send = np.where(hi, cnt[m], cnt[m + half])
            keep = np.where(hi, cnt[m + half], cnt[m])
            new.append(keep + send[partner])
        cnt = new
    k = LANES >> 2
    src = 8 * (LANES & 3) + ((k & 1) << 2) + (k & 2) + ((k >> 2) & 1)
    return cnt[0][src]


def emulate(rows, w32, seed, step, blocks, popcount=True):
    """The kernel's writes: -> ((rows, w32) int32 planes, (rows,) f32 pc or
    None, (rows * nb,) count of stores at each 16-byte address)."""
    nb = w32 // 4
    words = np.zeros((rows * nb, 4), np.int64)
    stores = np.zeros(rows * nb, np.int64)
    pc = np.full(rows, np.nan, np.float32) if popcount else None
    rr, bb = lane_items(nb)
    k = np.arange(nb)[:, None]
    for _, c in warp_chunks(rows, blocks):
        r0 = c << 5
        n_in = min(32, rows - r0)
        ctr = [torch.from_numpy(((r0 + rr) & M32).astype(np.int64)),
               torch.from_numpy(bb.astype(np.int64)),
               torch.full(rr.shape, step & M32, dtype=torch.int64),
               torch.full(rr.shape, step >> 32, dtype=torch.int64)]
        v = np.stack([o.numpy() for o in gen.philox4x32_10(
            *ctr, seed & M32, seed >> 32)], axis=-1)          # (nb, 32, 4)
        addr = r0 * nb + 32 * k + LANES[None, :]
        live = rr < n_in
        assert (addr[live] == ((r0 + rr) * nb + bb)[live]).all()
        np.add.at(stores, addr[live], 1)
        words[addr[live]] = v[live]
        if popcount:
            cnt = popc4(v)
            if nb == 8:
                row_cnt = reduce_scatter(cnt)
            else:                       # the warp's 32 shared counts
                row_cnt = np.zeros(32, np.int64)
                np.add.at(row_cnt, rr[live], cnt[live])
            pc[r0:r0 + n_in] = row_cnt[:n_in]
    planes = words.reshape(rows, w32)
    planes = np.where(planes > 0x7FFFFFFF, planes - (1 << 32),
                      planes).astype(np.int32)
    return planes, pc, stores


@pytest.mark.parametrize("grid", ["full", "small"])
@pytest.mark.parametrize("w32", [4, 12, 32, 64, 128])
@pytest.mark.parametrize("rows", [(1 << 12) - 37, 1, 33, 1 << 10])
def test_walk_writes_each_item_once_and_equals_plain(rows, w32, grid):
    sms, per_sm = (132, 8) if grid == "full" else (2, 1)
    blocks = grid_blocks(rows, sms, per_sm)
    seed, step = 1_000_003, (1 << 32) + 7         # the high step word is 1
    planes, pc, stores = emulate(rows, w32, seed, step, blocks)
    assert (stores == 1).all()                     # each item once, no other
    want, want_pc = gen.gen_planes_plain(torch.arange(rows), w32, seed, step)
    np.testing.assert_array_equal(planes, want.numpy())
    np.testing.assert_array_equal(pc, want_pc.numpy())
    # pc[r] sums exactly row r's blocks
    row_bits = popc4(planes.astype(np.int64).reshape(rows, -1, 4)
                     & M32).sum(axis=1)
    np.testing.assert_array_equal(pc, row_bits.astype(np.float32))


@pytest.mark.parametrize("w32", [32, 12])
def test_walk_without_popcounts_writes_the_same_planes(w32):
    rows = 1000
    blocks = grid_blocks(rows, 3, 2)
    with_pc, _, _ = emulate(rows, w32, 5, 9, blocks)
    alone, pc, stores = emulate(rows, w32, 5, 9, blocks, popcount=False)
    assert pc is None and (stores == 1).all()
    np.testing.assert_array_equal(alone, with_pc)


@pytest.mark.parametrize("w32", [4, 12, 32, 64, 128])
def test_items_of_a_chunk_cover_its_rows_and_blocks_once(w32):
    """Lane l's items q = l + 32 k are (q / nb, q % nb): the 32 * nb items
    of a chunk are its 32 rows' nb blocks, each once, without a division
    in the loop."""
    nb = w32 // 4
    rr, bb = lane_items(nb)
    q = 32 * np.arange(nb)[:, None] + LANES[None, :]
    np.testing.assert_array_equal(rr, q // nb)
    np.testing.assert_array_equal(bb, q % nb)


def test_reduce_scatter_puts_row_i_in_lane_i():
    rng = np.random.default_rng(0)
    cnt = rng.integers(0, 129, size=(8, 32))
    got = reduce_scatter(cnt)
    # row 4k + g is item k of the 8 lanes 8g .. 8g + 7
    want = [cnt[i >> 2, 8 * (i & 3):8 * (i & 3) + 8].sum() for i in range(32)]
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows", [1 << 32, (1 << 32) - 37])
def test_last_chunk_below_2p32_rows(rows):
    """The last chunk of a 2^32-row batch: its first row is 64-bit, the
    counter's row word (uint32) r0 + rr stays below 2^32, and its items
    equal the plain version's rows."""
    nb = 8
    c = -(-rows // 32) - 1
    r0, n_in = c << 5, min(32, rows - (c << 5))
    rr, bb = lane_items(nb)
    live = rr < n_in
    row = (r0 & M32) + rr
    assert row.max() < 1 << 32 and r0 + int(rr[live].max()) == rows - 1
    addr = r0 * nb + 32 * np.arange(nb)[:, None] + LANES[None, :]
    assert int(addr[live].max()) == rows * nb - 1 > M32
    ids = torch.from_numpy(np.unique(row[live]).astype(np.int64))
    want = gen.gen_planes_plain(ids, 32, 3, 2**40, popcount=False)
    v = np.stack([o.numpy() for o in gen.philox4x32_10(
        torch.from_numpy(row.astype(np.int64)),
        torch.from_numpy(bb.astype(np.int64)),
        torch.zeros(rr.shape, dtype=torch.int64),
        torch.full(rr.shape, 2**40 >> 32, dtype=torch.int64), 3, 0)],
        axis=-1)
    got = np.zeros((n_in, 32), np.int64)
    for k in range(nb):
        for lane in range(32):
            if live[k, lane]:
                got[rr[k, lane], 4 * bb[k, lane]:4 * bb[k, lane] + 4] = \
                    v[k, lane]
    np.testing.assert_array_equal(
        np.where(got > 0x7FFFFFFF, got - (1 << 32), got).astype(np.int32),
        want.numpy())
