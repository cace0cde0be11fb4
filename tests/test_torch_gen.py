"""The plane generator of the port's bench and at-scale stream
(kmersgwas_tpu_torch.ops.gen, K6) on the CPU: the plain version's Philox
against a pure-Python big-integer Philox4x32-10 and Random123's known
answers, its popcounts against numpy's bit count, and regeneration of a
batch, or of single rows, from (seed, step). The kernel itself is checked
against the plain version on the card (tests/test_torch_gpu.py,
chip_smoke.py)."""
import numpy as np
import pytest
import torch

from kmersgwas_tpu_torch.ops import gen

M32 = 0xFFFFFFFF


def philox_ref(ctr, key):
    """Philox4x32-10 in Python integers (Random123's philox4x32_R with
    R = 10: a round with the key, then a key bump, ten rounds)."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        p0 = 0xD2511F53 * c0
        p1 = 0xCD9E8D57 * c2
        c0, c1, c2, c3 = ((p1 >> 32) ^ c1 ^ k0, p1 & M32,
                          (p0 >> 32) ^ c3 ^ k1, p0 & M32)
        k0 = (k0 + 0x9E3779B9) & M32
        k1 = (k1 + 0xBB67AE85) & M32
    return c0, c1, c2, c3


def planes_ref(rows, w32, seed, step):
    """(rows, w32) uint32 words by the definition: word j of row r is
    component j % 4 of Philox(counter (r, j // 4, step lo, step hi), key
    (seed lo, seed hi))."""
    out = np.empty((len(rows), w32), np.uint32)
    for i, r in enumerate(rows):
        for b in range(w32 // 4):
            out[i, 4 * b:4 * b + 4] = philox_ref(
                (r, b, step & M32, step >> 32), (seed & M32, seed >> 32))
    return out


def words(planes: torch.Tensor) -> np.ndarray:
    return planes.numpy().view(np.uint32)


# Random123's known-answer vectors for philox4x32_10 (kat_vectors)
KAT = [((0, 0, 0, 0), (0, 0),
        (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
       ((M32, M32, M32, M32), (M32, M32),
        (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
       ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
        (0xA4093822, 0x299F31D0),
        (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1))]


@pytest.mark.parametrize("ctr,key,want", KAT)
def test_philox_known_answers(ctr, key, want):
    assert philox_ref(ctr, key) == want
    got = gen.philox4x32_10(*(torch.tensor([c], dtype=torch.int64)
                              for c in ctr), *key)
    assert tuple(int(g) for g in got) == want


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_philox_matches_bigint_on_random_counters(seed):
    rng = np.random.default_rng(seed)
    ctr = rng.integers(0, 1 << 32, size=(4, 64), dtype=np.uint64)
    key = [int(k) for k in rng.integers(0, 1 << 32, size=2, dtype=np.uint64)]
    got = gen.philox4x32_10(*(torch.from_numpy(c.astype(np.int64))
                              for c in ctr), *key)
    got = np.stack([g.numpy() for g in got], axis=1)
    want = np.array([philox_ref(tuple(int(x) for x in ctr[:, i]), key)
                     for i in range(ctr.shape[1])])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rows,w32,seed,step", [
    (37, 32, 1 << 20, 0), (5, 8, 2**64 - 1, 2**64 - 1),
    (9, 12, 1_000_003, 1103), (3, 4, 0, 2**40 + 5)])
def test_plain_planes_match_definition(rows, w32, seed, step):
    planes, pc = gen.gen_planes_plain(torch.arange(rows), w32, seed, step)
    assert planes.dtype == torch.int32 and planes.shape == (rows, w32)
    np.testing.assert_array_equal(words(planes),
                                  planes_ref(range(rows), w32, seed, step))
    bits = np.unpackbits(words(planes).view(np.uint8), axis=1)
    np.testing.assert_array_equal(pc.numpy(),
                                  bits.sum(axis=1).astype(np.float32))


def test_cpu_wrapper_takes_the_plain_version():
    before = gen.gen_planes.launches
    a = gen.gen_planes(300, 32, 11, 4, "cpu")
    b = gen.gen_planes_plain(torch.arange(300), 32, 11, 4)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert gen.gen_planes.launches == before      # no kernel on the CPU


@pytest.mark.parametrize("rows,w32", [(300, 32), (77, 4)])
def test_planes_without_popcounts_are_the_same_planes(rows, w32):
    """popcount=False (the probes' generators without a fused popcount)
    gives the planes of popcount=True and nothing else."""
    planes, _ = gen.gen_planes(rows, w32, 9, 3, "cpu")
    alone = gen.gen_planes(rows, w32, 9, 3, "cpu", popcount=False)
    plain = gen.gen_planes_plain(torch.arange(rows), w32, 9, 3,
                                 popcount=False)
    assert isinstance(alone, torch.Tensor) and isinstance(plain, torch.Tensor)
    assert torch.equal(alone, planes) and torch.equal(plain, planes)


def test_batch_regenerates_from_seed_and_step():
    p1, c1 = gen.gen_planes(4096, 32, 5, 17, "cpu")
    p2, c2 = gen.gen_planes(4096, 32, 5, 17, "cpu")
    assert torch.equal(p1, p2) and torch.equal(c1, c2)
    # rows regenerate alone, each from its own (step, row): a row of step
    # 17 and one of step 18 in one call
    nxt, _ = gen.gen_planes(4096, 32, 5, 18, "cpu")
    rid = torch.tensor([0, 4095, 1234, 7])
    steps = torch.tensor([17, 17, 18, 18])
    got, gpc = gen.gen_planes_plain(rid, 32, 5, steps)
    want = torch.stack([p1[0], p1[4095], nxt[1234], nxt[7]])
    assert torch.equal(got, want)
    assert not torch.equal(p1, nxt)
    other_seed, _ = gen.gen_planes(4096, 32, 6, 17, "cpu")
    assert not torch.equal(p1, other_seed)
    # every bit position is fair (4096 rows: 5 sigma is 0.039)
    bits = np.unpackbits(words(p1).view(np.uint8), axis=1)
    assert np.abs(bits.mean(axis=0) - 0.5).max() < 0.039


@pytest.mark.parametrize("kw,match", [
    (dict(rows=8, w32=6, seed=1, step=0, device="cpu"), "multiple of 4"),
    (dict(rows=0, w32=8, seed=1, step=0, device="cpu"), "rows"),
    (dict(rows=8, w32=8, seed=-1, step=0, device="cpu"), "seed"),
    (dict(rows=8, w32=8, seed=1, step=1 << 64, device="cpu"), "step"),
    (dict(rows=8, w32=8, seed=1, step=0, device="meta"), "no gen_planes")])
def test_wrapper_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        gen.gen_planes(**kw)
