"""The bound of K1's select launch (csrc/score_topw.cuh
`topw_select_kernel`, its stream path) on the CPU.

The kernel runs only on the card (tests/test_torch_gpu.py holds it to the
plain select there). Here the bound it sorts above, the w-th largest of
the 1024 threads' two largest score keys (thread t holding the candidates
j with j % 1024 == t), is held to `ops/score._select`: at most the list's
w-th largest score, so the candidates at or above it hold the top-w, on
random, dyadic (tie-heavy), tied and -inf lists; and the kernel's
bit-by-bit rounds that find it (`block_kth`) are held to a sort.
"""
import numpy as np
import pytest
import torch

from kmersgwas_tpu_torch.ops import score

THREADS = 1024            # csrc/score_topw.cuh SEL_THREADS


def score_keys(v):
    """tile_top3.cuh score_key: the order-preserving uint32 of a float."""
    u = np.asarray(v, np.float32).view(np.uint32)
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def bound_of(sk, w):
    """The kernel's bound: the w-th largest of the threads' top-2 score
    keys (0 for a thread with fewer than two candidates)."""
    n = len(sk)
    cols = np.zeros(-(-n // THREADS) * THREADS, np.uint32)
    cols[:n] = sk
    per = np.sort(cols.reshape(-1, THREADS), axis=0)[::-1]   # per thread
    top2 = np.concatenate([per[:2], np.zeros((max(0, 2 - len(per)),
                                              THREADS), np.uint32)])
    return np.sort(top2.ravel())[::-1][w - 1]


def kth_by_bits(a, b, w):
    """score_topw.cuh block_kth: the w-th largest of the keys a and b (one
    each a thread), bit by bit from the top, each bit decided by the count
    of keys on the decided bits with that bit set."""
    keys = np.concatenate([a, b]).astype(np.int64)
    kth, rem = 0, w
    for bit in range(31, -1, -1):
        hi = kth | (1 << bit)
        mask = (0xffffffff << bit) & 0xffffffff
        n = int(((keys & mask) == hi).sum())
        if n >= rem:
            kth = hi
        else:
            rem -= n
    return kth


def make_list(n, kind, rng):
    """n candidates (scores, unique lanes) of one list; no -0.0, no NaN
    (the tile launch writes neither)."""
    g = rng.permutation(max(n, 1) * 4)[:n].astype(np.int32)
    if kind == "random":
        v = rng.normal(size=n).astype(np.float32)
    elif kind == "dyadic":                  # a few hundred distinct scores
        v = (np.round(rng.normal(size=n) * 8) / 8).astype(np.float32)
    elif kind == "tied":
        v = np.full(n, 2.5, np.float32)
    elif kind == "neg_inf":                 # 100 finite scores, the rest -inf
        v = np.full(n, -np.inf, np.float32)
        v[rng.choice(n, size=min(n, 100), replace=False)] = rng.normal(
            size=min(n, 100))
    else:
        raise ValueError(kind)
    v[v == 0] = 0.0
    return v, g


@pytest.mark.parametrize("kind", ["random", "dyadic", "tied", "neg_inf"])
@pytest.mark.parametrize("n,w", [(4097, 1), (4097, 1024), (46_875, 256),
                                 (49_152, 1024), (100_000, 128)])
def test_bound_is_at_most_the_w_th_score(kind, n, w):
    """The bound is at or below the list's w-th largest score, so every
    candidate of the top-w is at or above it, and at least w are."""
    rng = np.random.default_rng(7 * n + w)
    v, g = make_list(n, kind, rng)
    sk = score_keys(v)
    b = bound_of(sk, w)
    want_v, _ = score._select(torch.from_numpy(v)[None],
                              torch.from_numpy(g)[None], w)
    assert b <= score_keys(want_v[0].numpy())[-1]
    assert int((sk >= b).sum()) >= w


@pytest.mark.parametrize("kind", ["random", "dyadic", "tied", "neg_inf"])
@pytest.mark.parametrize("w", [1, 2, 255, 1000, 1024])
def test_block_kth_bits_equal_the_sorted_key(kind, w):
    """The bound's bit-by-bit rounds give the w-th largest of the 2048 keys
    (with filler keys 0 of threads that hold fewer than two)."""
    rng = np.random.default_rng(w)
    v, _ = make_list(2 * THREADS, kind, rng)
    sk = score_keys(v)
    sk[rng.choice(2 * THREADS, size=37, replace=False)] = 0
    a, b = sk[:THREADS], sk[THREADS:]
    assert kth_by_bits(a, b, w) == np.sort(sk)[::-1][w - 1]


@pytest.mark.parametrize("lists,n_tiles", [(1, 7), (2, 7), (2, 1001)])
def test_topw_select_plain_on_the_cpu(lists, n_tiles):
    """topw_select on CPU tensors is the plain select of each list's tiles
    (K8's list L: the tiles t with t % 2 == L) and the guard AND."""
    rng = np.random.default_rng(n_tiles)
    p, w = 3, 16
    tv = torch.from_numpy(np.round(rng.normal(size=(p, 3 * n_tiles)) * 4)
                          .astype(np.float32) / 4)
    tg = torch.from_numpy(np.stack([rng.permutation(3 * n_tiles)
                                    for _ in range(p)]).astype(np.int32))
    tc = torch.from_numpy(rng.integers(0, 4, size=(p, n_tiles)).astype(
        np.int32))
    tc[1, n_tiles // 2] = 4
    v, g, ok = score.topw_select(tv, tg, tc, w, lists)
    assert v.shape == g.shape == (lists, p, w)
    assert ok.tolist() == [True, False, True]
    for l in range(lists):
        idx = [3 * t + s for t in range(l, n_tiles, lists) for s in range(3)]
        wv, wg = score._select(tv[:, idx], tg[:, idx], w)
        assert torch.equal(v[l], wv) and torch.equal(g[l], wg)
