"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and the scan and kinship on the card against the same
drivers on the CPU.

They skip without CUDA. On a machine with the card (where jax may be
absent, so tests/conftest.py is left out) run:

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:cacheprovider

This file imports neither jax nor the JAX package's jax modules.
"""
import numpy as np
import pytest
import torch

from kmersgwas_tpu_torch.ops import bitplanes, gen, kinship, score

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def batch(rows, n, p, seed, dev, gaussian=False, ties=False):
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    bits = rng.integers(0, 2, size=(rows, n)).astype(np.uint8)
    bits[rows - rows // 8 - 5:] = 0                      # padding rows
    if ties:
        tie_rows(bits, rng)
    padded = np.zeros((rows, n_pad), np.uint8)
    padded[:, :n] = bits
    packed = bitplanes.as_planes(bitplanes.pack_bits_np(padded)).to(dev)
    y = (rng.normal(size=(n, p)) if gaussian
         else np.round(rng.uniform(-8, 8, size=(n, p)) * 8) / 8)  # dyadic
    yp, ysum = score.prepare_phenotypes(y, n_pad, dev)
    return packed, bitplanes.popcount_rows(packed), yp, ysum


def tie_rows(bits, rng):
    """Rows that load the per-tile top-3 (csrc/tile_top3.cuh) with ties, in
    place, in the first five 128-row tiles: runs of 1-4 equal rows; tile 1
    all padding; tile 2's rows with 1-4 samples set (under min_count 5, so
    the MAC filter scores them 0.0 in every column); tile 3 padding but
    rows t, t + 32, t + 64, which one lane holds; in tile 4 rows r + 1 and
    r + 32 equal to row r (ties across lanes and within one)."""
    rows, n = bits.shape
    assert rows >= 640
    r = 0
    while r < rows:
        run = int(rng.integers(1, 5))
        bits[r:r + run] = bits[r]
        r += run
    bits[128:384] = 0
    for r in range(256, 384):
        bits[r, rng.choice(n, size=int(rng.integers(1, 5)),
                           replace=False)] = 1
    one_lane = [397, 429, 461]
    keep = bits[one_lane].copy()
    bits[384:512] = 0
    bits[one_lane] = keep
    for r in range(512, 607, 5):
        bits[[r + 1, r + 32]] = bits[r]


@pytest.mark.parametrize("rows,n,p,w", [(1024, 100, 3, 16),
                                        (1024, 100, 70, 256),
                                        (4096, 1008, 101, 256)])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_kernels_equal_plain(cuda, rows, n, p, w, precision):
    packed, pc, yp, ysum = batch(rows, n, p, rows + p, cuda)
    kw = dict(n_used=n, min_count=5, precision=precision)
    launches = (score.score_batch_t_topw.launches,
                score.score_batch_t_bmax.launches)
    ks, kb = score.score_batch_t_bmax(packed, pc, yp, ysum, **kw)
    ps, pb = score.scores_and_bmax_plain(packed, pc, yp, ysum, **kw)
    assert torch.equal(ks, ps) and torch.equal(kb, pb)
    q = torch.topk(ps, 16, dim=1).values[:, -1].contiguous()
    for th in (torch.full((p,), float("-inf"), device=cuda), q,
               torch.full((p,), float("inf"), device=cuda)):
        args = (packed, pc, yp, ysum, th)
        k_out = score.score_batch_t_topw(*args, tile_rows=128, cand_w=w, **kw)
        p_out = score.topw_plain(*args, tile_rows=128, cand_w=w, **kw)
        for a, b in zip(k_out, p_out):
            assert torch.equal(a, b)
    assert (score.score_batch_t_topw.launches,
            score.score_batch_t_bmax.launches) == (launches[0] + 3,
                                                   launches[1] + 1)


@pytest.mark.parametrize("rows,n,p", [(1024, 100, 3), (4096, 1008, 101)])
@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("ties", [False, True])
def test_tilemax_kernel_equals_plain(cuda, rows, n, p, precision, ties):
    """K3's nine planes equal the plain version's bit for bit (dyadic
    phenotypes), with runs of equal rows inside tiles so that the 2nd and
    3rd values tie (n2, n3 > 1), and on `tie_rows`."""
    packed, pc, yp, ysum = batch(rows, n, p, rows + 3 * p, cuda, ties=ties)
    if not ties:
        packed.view(-1, 4, packed.shape[1])[: rows // 8, 1:] = \
            packed.view(-1, 4, packed.shape[1])[: rows // 8, :1]
        pc = bitplanes.popcount_rows(packed)
    kw = dict(n_used=n, min_count=5, tile_rows=128, precision=precision)
    launches = score.score_batch_t_tilemax.launches
    sc = score.scores_t_plain(packed, pc, yp, ysum, n_used=n, min_count=5,
                              precision=precision)
    q = torch.topk(sc, 16, dim=1).values[:, -1].contiguous()
    for th in (torch.full((p,), float("-inf"), device=cuda), q,
               torch.full((p,), float("inf"), device=cuda)):
        got = score.score_batch_t_tilemax(packed, pc, yp, ysum, th, **kw)
        want = score.tilemax_plain(packed, pc, yp, ysum, th, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        assert bool((got[6] > 1).any()) and bool((got[7] > 1).any())
    assert score.score_batch_t_tilemax.launches == launches + 3


@pytest.mark.parametrize("p", [1, 3, 8, 101, 104, 128, 129, 256, 509, 1013])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_tensor_core_kernels_equal_plain(cuda, p, precision):
    """K1, K3 and K8 (the tensor-core body, csrc/score_wgmma.cuh) against
    their plain versions bit for bit on dyadic phenotypes, with padding
    rows and runs of equal rows inside tiles, at every column chunk the
    body is built for (P = 1 to 1013: one chunk of 8 to eight of 128)."""
    rows, n = 1024, 300
    packed, pc, yp, ysum = batch(rows, n, p, 7 * p, cuda)
    packed.view(-1, 4, packed.shape[1])[: rows // 8, 1:] = \
        packed.view(-1, 4, packed.shape[1])[: rows // 8, :1]
    pc = bitplanes.popcount_rows(packed)
    kw = dict(n_used=n, min_count=5, precision=precision)
    sc = score.scores_t_plain(packed, pc, yp, ysum, **kw)
    q = torch.topk(sc, 16, dim=1).values[:, -1].contiguous()
    launches = (score.score_batch_t_topw.launches,
                score.score_batch_t_tilemax.launches,
                score.score_batch_t_parity.launches)
    for th in (torch.full((p,), float("-inf"), device=cuda), q,
               torch.full((p,), float("inf"), device=cuda)):
        args = (packed, pc, yp, ysum, th)
        for got, want in (
                (score.score_batch_t_topw(*args, tile_rows=128, cand_w=64,
                                          **kw),
                 score.topw_plain(*args, tile_rows=128, cand_w=64, **kw)),
                (score.score_batch_t_tilemax(*args, tile_rows=128, **kw),
                 score.tilemax_plain(*args, tile_rows=128, **kw)),
                (score.score_batch_t_parity(*args, tile_rows=256, w=32,
                                            **kw),
                 score.parity_plain(*args, tile_rows=256, w=32, **kw))):
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    tm = score.tilemax_plain(packed, pc, yp, ysum, q, tile_rows=128, **kw)
    assert bool((tm[6] > 1).any()) and bool((tm[7] > 1).any())
    assert (score.score_batch_t_topw.launches,
            score.score_batch_t_tilemax.launches,
            score.score_batch_t_parity.launches) == tuple(
                x + 3 for x in launches)


@pytest.mark.parametrize("precision", ["default", "highest"])
@pytest.mark.parametrize("ties", [False, True])
def test_topw_lists_equal_the_top_w_of_the_score_plane(cuda, precision,
                                                       ties):
    """K1's top-W lists (its tile launch, then its select) equal the plain
    per-tile top-3 and select applied to K2's score plane for the same
    dyadic batch, also on `tie_rows`: K1's epilogue against the plain one
    on the same scores (both kernels on the tensor-core body, K2 through
    the score-plane epilogue of csrc/score_plane.cu)."""
    packed, pc, yp, ysum = batch(8192, 1008, 101, 11, cuda, ties=ties)
    kw = dict(n_used=1008, min_count=5, precision=precision)
    ks, _ = score.score_batch_t_bmax(packed, pc, yp, ysum, **kw)
    q = torch.topk(ks, 16, dim=1).values[:, -1].contiguous()
    for th in (q, torch.full((101,), float("-inf"), device=cuda)):
        kv, kg, kok = score.score_batch_t_topw(packed, pc, yp, ysum, th,
                                               tile_rows=128, cand_w=256,
                                               **kw)
        v3, lanes, ok = score._tile_top3(ks, th, 128)
        v, g = score._select(v3.reshape(101, -1), lanes.reshape(101, -1),
                             256)
        assert torch.equal(kv, v) and torch.equal(kg, g)
        assert torch.equal(kok, ok)


@pytest.mark.parametrize("p", [1, 3, 8, 101, 104, 128, 129, 256, 509, 1013])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_score_plane_kernels_equal_plain(cuda, p, precision):
    """K2 (scores and contiguous 16-lane block maxima), K4 (scores) and K5
    (row-major scores, no padding mask), the score plane's three modes on
    the tensor-core body, bit-equal to their plain versions on dyadic
    phenotypes with padding rows, at every column chunk (P = 1 to 1013: one
    chunk of 8 to eight of 128), also on a column subset as the fallback
    passes it (y_padded[:, cols])."""
    rows, n = 1024, 300
    packed, pc, yp, ysum = batch(rows, n, p, 9 * p, cuda)
    kw = dict(n_used=n, min_count=5, precision=precision)
    launches = (score.score_batch_t_bmax.launches,
                score.score_batch_t.launches, score.score_batch.launches)
    cols = torch.tensor(sorted({0, p // 3, p // 2, p - 1}), device=cuda)
    for y, ys in ((yp, ysum), (yp[:, cols], ysum[cols])):
        ks, kb = score.score_batch_t_bmax(packed, pc, y, ys, **kw)
        ps, pbm = score.scores_and_bmax_plain(packed, pc, y, ys, **kw)
        assert torch.equal(ks, ps) and torch.equal(kb, pbm)
        assert torch.equal(score.score_batch_t(packed, pc, y, ys, **kw), ps)
        assert bool((ks == float("-inf")).any())
        kr = score.score_batch(packed, pc, y, ys, **kw)
        assert torch.equal(kr, score.scores_plain(packed, pc, y, ys, **kw))
        assert bool(torch.isfinite(kr).all())
    assert (score.score_batch_t_bmax.launches, score.score_batch_t.launches,
            score.score_batch.launches) == tuple(x + 2 for x in launches)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_score_rows_equals_score_t_transposed(cuda, gaussian, precision):
    """K5 and K4 are two modes of one kernel on one body: K5's (R, P)
    scores are K4's (P, R) scores transposed, with -inf (padding rows) as
    0, bit for bit, on Gaussian phenotypes too, at one chunk (P = 101) and
    at several (P = 257)."""
    for p in (101, 257):
        packed, pc, yp, ysum = batch(8192, 1008, p, 15 + p, cuda, gaussian)
        kw = dict(n_used=1008, min_count=5, precision=precision)
        k4 = score.score_batch_t(packed, pc, yp, ysum, **kw)
        k5 = score.score_batch(packed, pc, yp, ysum, **kw)
        assert bool((k4 == float("-inf")).any())
        assert torch.equal(k5, torch.where(k4 == float("-inf"), 0.0, k4).T)


@pytest.mark.parametrize("gaussian", [False, True])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_score_bmax_equals_topw_values(cuda, gaussian, precision):
    """K2 and K1 share the tensor-core body: at the same P (so the same
    column chunks) K2's score at every lane of K1's list is K1's value, bit
    for bit, on Gaussian phenotypes too, so the fallback's merge of K1's
    buffered candidates with K2's rescored batch compares like with
    like."""
    packed, pc, yp, ysum = batch(8192, 1008, 101, 13, cuda, gaussian)
    kw = dict(n_used=1008, min_count=5, precision=precision)
    ks, _ = score.score_batch_t_bmax(packed, pc, yp, ysum, **kw)
    q = torch.topk(ks, 64, dim=1).values[:, -1].contiguous()
    for th in (q, torch.full((101,), float("-inf"), device=cuda)):
        kv, kg, _ = score.score_batch_t_topw(packed, pc, yp, ysum, th,
                                             tile_rows=128, cand_w=128, **kw)
        assert bool(torch.isfinite(kv).all())
        assert torch.equal(ks.gather(1, kg.long()), kv)


@pytest.mark.parametrize("rows,n,p", [(1024, 100, 3), (4096, 1008, 101)])
@pytest.mark.parametrize("precision", ["default", "highest"])
def test_score_t_and_rows_kernels_equal_plain(cuda, rows, n, p, precision):
    """K4 (transposed, -inf padding) and K5 (row-major, no padding mask)
    equal their plain versions bit for bit on dyadic phenotypes."""
    packed, pc, yp, ysum = batch(rows, n, p, rows + 5 * p, cuda)
    kw = dict(n_used=n, min_count=5, precision=precision)
    launches = (score.score_batch_t.launches, score.score_batch.launches)
    kt = score.score_batch_t(packed, pc, yp, ysum, **kw)
    kr = score.score_batch(packed, pc, yp, ysum, **kw)
    assert torch.equal(kt, score.scores_t_plain(packed, pc, yp, ysum, **kw))
    assert torch.equal(kr, score.scores_plain(packed, pc, yp, ysum, **kw))
    assert bool((kt == float("-inf")).any()) and bool(torch.isfinite(kr).all())
    assert (score.score_batch_t.launches,
            score.score_batch.launches) == (launches[0] + 1, launches[1] + 1)


@pytest.mark.parametrize("rows,n,n_rows", [(4096, 100, 4096),
                                           (4096, 100, 4001),
                                           (20000, 1008, 19963),
                                           (640, 300, 1),
                                           (4096, 1008, 77),
                                           (1 << 16, 100, (1 << 16) - 5),
                                           (1 << 17, 1008, (1 << 17) - 99)])
def test_kinship_kernel_equals_plain(cuda, rows, n, n_rows):
    """K7 adds the exact +-1 Gram of rows [0, n_rows) into acc in place,
    bit-equal to the plain version; the rows past n_rows (random here) add
    nothing. Shapes: n_rows below one 128-row chunk, ragged last chunks,
    fewer work items than blocks (640 x 300: 6 pairs x 1 chunk), one pair
    split over every block (n_pad 128, 512 chunks), spans crossing pairs
    (n_pad 1024, 1024 chunks)."""
    packed, _, _, _ = batch(rows, n, 1, rows + n, cuda)
    packed = packed.clone()
    packed[n_rows:] = torch.randint(-2 ** 31, 2 ** 31, packed[n_rows:].shape,
                                    dtype=torch.int32, device=cuda)
    n_pad = packed.shape[1] * 32
    acc0 = torch.randint(-9, 9, (n_pad, n_pad), dtype=torch.int32,
                         device=cuda)
    acc = acc0.clone()
    launches = kinship.kinship_accumulate.launches
    kinship.kinship_accumulate(acc, packed, n_rows)
    want = kinship.kinship_gram_plain(packed, n_rows)
    assert torch.equal(acc - acc0, want)
    assert torch.equal(want, want.T)
    assert kinship.kinship_accumulate.launches == launches + 1


@pytest.mark.parametrize("rows,n,n_rows", [(4096, 1008, 4096),
                                           (4096, 300, 77),
                                           (20000, 100, 19963)])
def test_kinship_transpose_kernel_equals_plain(cuda, rows, n, n_rows):
    """K7's bit transpose: the bits of rows [0, n_rows) sample-major in
    128-row chunks, rows past n_rows as 0, equal to its plain version."""
    packed, _, _, _ = batch(rows, n, 1, rows + 7, cuda)
    launches = kinship.transpose_bits.launches
    got = kinship.transpose_bits(packed, n_rows)
    torch.cuda.synchronize()
    assert kinship.transpose_bits.launches == launches + 1
    assert torch.equal(got, kinship.transpose_bits_plain(packed, n_rows))


@pytest.mark.parametrize("nt", [1, 128, 2048])
def test_tile_topc_kernel_equals_plain(cuda, nt):
    """K9's tile_topc, the stable rank, on columns with ties and -inf
    maxima (a whole column of them too), equals the chain of inserts."""
    from kmersgwas_tpu_torch.ops import tilereduce as tred
    rng = np.random.default_rng(nt)
    m1 = np.round(rng.normal(size=(6, nt)) * 2).astype(np.float32) \
        + np.float32(0)
    m1[rng.random((6, nt)) < 0.2] = -np.inf
    m1[3] = -np.inf
    m1[4] = 1.0
    m1 = torch.from_numpy(m1).to(cuda)
    launches = tred.tile_topc.launches
    v, i = tred.tile_topc(m1)
    torch.cuda.synchronize()
    assert tred.tile_topc.launches == launches + 1
    pv, pi = tred.tile_topc_plain(m1)
    assert torch.equal(v, pv) and torch.equal(i, pi)


@pytest.mark.parametrize("rows,w32,seed,step", [(4096, 32, 1 << 20, 3),
                                               ((1 << 16) - 37, 32, 5, 2**40),
                                               (1000, 12, 9, 2**64 - 1),
                                               (1, 32, 3, 1),
                                               (33, 4, 7, 2**32),
                                               ((1 << 20) - 37, 64, 11,
                                                2**32 + 5),
                                               (4059, 128, 2, 8),
                                               ((1 << 21) + 5, 32, 1, 2**33)])
def test_gen_planes_kernel_equals_plain(cuda, rows, w32, seed, step):
    before = gen.gen_planes.launches
    planes, pc = gen.gen_planes(rows, w32, seed, step, cuda)
    torch.cuda.synchronize()
    assert gen.gen_planes.launches == before + 1
    want, want_pc = gen.gen_planes_plain(torch.arange(rows, device=cuda),
                                         w32, seed, step)
    assert torch.equal(planes, want) and torch.equal(pc, want_pc)
    assert torch.equal(pc, bitplanes.popcount_rows(planes))


@pytest.mark.parametrize("n_valid", [4096, 3001, 0])
def test_kinship_accumulate_masked_launches_k7_on_a_prefix(cuda, n_valid):
    """kinship_accumulate_masked on the card: a prefix mask runs K7 (its
    transpose and Gram each launched once) over the valid rows, bit-equal
    to the plain masked Gram; a mask that is not a prefix raises, and
    nothing is launched."""
    packed, _, _, _ = batch(4096, 300, 1, 17, cuda)
    packed = packed.clone()
    packed[n_valid:] = torch.randint(-2 ** 31, 2 ** 31,
                                     packed[n_valid:].shape,
                                     dtype=torch.int32, device=cuda)
    n_pad = packed.shape[1] * 32
    valid = (torch.arange(4096) < n_valid).to(torch.int8)
    acc0 = torch.randint(-9, 9, (n_pad, n_pad), dtype=torch.int32)
    want = kinship.kinship_accumulate_masked(acc0.clone(), packed.cpu(),
                                             valid)
    launches = (kinship.kinship_accumulate.launches,
                kinship.transpose_bits.launches)
    got = kinship.kinship_accumulate_masked(acc0.to(cuda), packed,
                                            valid.to(cuda))
    assert torch.equal(got.cpu(), want)
    step = int(n_valid > 0)
    assert (kinship.kinship_accumulate.launches,
            kinship.transpose_bits.launches) == (launches[0] + step,
                                                 launches[1] + step)
    holes = valid.clone()
    holes[5] = 0
    holes[-1] = 1
    with pytest.raises(ValueError, match="prefix"):
        kinship.kinship_accumulate_masked(acc0.to(cuda), packed,
                                          holes.to(cuda))
    assert kinship.kinship_accumulate.launches == launches[0] + step


def test_mesh_of_two_card_shards_equals_one_device(cuda, tmp_path):
    """A 2-shard mesh on cuda:0: associate (K1 on each shard's batch, K2 on
    its fallbacks) and kinship_from_table (K7 on each shard) equal one
    device's results on the card exactly."""
    from kmersgwas_tpu_torch.parallel import sharding
    from kmersgwas_tpu_torch.pipeline import kinship as km
    from kmersgwas_tpu_torch.pipeline import scan
    rng = np.random.default_rng(12)
    n, rows, kmer_len = 150, 40_000, 31
    base, names = write_table(tmp_path, rng, n, rows, kmer_len)
    y = np.round(rng.uniform(-8, 8, size=(n, 3)) * 8) / 8
    mesh = sharding.make_mesh(["cuda:0", "cuda:0"])
    kw = dict(kmer_len=kmer_len, n_top=8, batch_size=2048)
    one = scan.associate(base, names, y, list("abc"), device="cuda", **kw)
    launches = (score.score_batch_t_topw.launches,
                score.score_batch_t_bmax.launches)
    got = scan.associate(base, names, y, list("abc"), device="cuda",
                         mesh=mesh, **kw)
    n_batches = -(-got.n_tested // 2048)
    assert score.score_batch_t_topw.launches - launches[0] == 2 * n_batches
    assert score.score_batch_t_bmax.launches > launches[1]
    assert got.n_tested == one.n_tested
    for j in range(3):
        np.testing.assert_array_equal(got.rows[j], one.rows[j])
        np.testing.assert_array_equal(got.scores[j], one.scores[j])
    k7 = kinship.kinship_accumulate.launches
    kin = km.kinship_from_table(base, device="cuda", batch_size=4097)
    n_batches, k7 = kinship.kinship_accumulate.launches - k7, \
        kinship.kinship_accumulate.launches
    np.testing.assert_array_equal(
        km.kinship_from_table(base, device="cuda", batch_size=4097,
                              mesh=mesh), kin)
    # every batch launches K7 on both shards but a short last one, whose
    # rows may all fall in shard 0
    assert kinship.kinship_accumulate.launches - k7 >= 2 * n_batches - 1


def test_kinship_on_card_equals_cpu(cuda, tmp_path):
    """kinship_from_table on the card, both routes and a checkpointed
    resume, equals the CPU run exactly; K7 runs on every batch."""
    from kmersgwas_tpu_torch.pipeline import kinship as km
    rng = np.random.default_rng(8)
    base, _ = write_table(tmp_path, rng, 200, 30_000, 31)
    kw = dict(maf=0.05, batch_size=4096)
    want = km.kinship_from_table(base, device="cpu", **kw)
    launches = kinship.kinship_accumulate.launches
    for extra in ({}, {"dtable_cache": str(tmp_path / "k.dtable")},
                  {"checkpoint_path": str(tmp_path / "ck"),
                   "checkpoint_every": 2}):
        got = km.kinship_from_table(base, device="cuda", **kw, **extra)
        np.testing.assert_array_equal(got, want)
    assert kinship.kinship_accumulate.launches - launches >= 3 * 6


def test_kernel_wrappers_refuse_bad_shapes(cuda):
    packed, pc, yp, ysum = batch(256, 100, 3, 1, cuda)
    th = torch.zeros(3, device=cuda)
    kw = dict(n_used=100, min_count=5)
    with pytest.raises(ValueError, match="128-row tile"):
        score.score_batch_t_topw(packed, pc, yp, ysum, th, tile_rows=64,
                                 cand_w=8, **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        score.score_batch_t_bmax(packed[:200].contiguous(), pc[:200], yp,
                                 ysum, **kw)
    with pytest.raises(ValueError, match="multiple of 128"):
        score.score_batch(packed[:200].contiguous(), pc[:200], yp, ysum, **kw)
    with pytest.raises(ValueError, match="16-lane"):
        score.score_batch_t_bmax(packed, pc, yp, ysum, block=8, **kw)
    with pytest.raises(ValueError, match="128-row tiles"):
        score.score_batch_t_tilemax(packed, pc, yp, ysum, th, tile_rows=64,
                                    **kw)


def write_table(tmp_path, rng, n, rows, kmer_len):
    from kmersgwas_tpu.core import formats
    names = [f"acc{i}" for i in range(n)]
    base = str(tmp_path / "pop")
    wf = (n + 63) // 64
    raw = np.zeros((rows, 1 + wf), "<u8")
    raw[:, 0] = np.arange(rows, dtype=np.uint64) * np.uint64(7)
    bits = np.zeros((rows, wf * 64), np.uint8)
    bits[:, :n] = rng.random((rows, n)) < rng.uniform(0.02, 0.98, (rows, 1))
    raw[:, 1:] = np.packbits(bits, axis=1, bitorder="little").view("<u8")
    with open(base + ".table", "wb") as f:
        formats.write_table_header(f, n, kmer_len)
        raw.tofile(f)
    formats.write_names(base, names)
    return base, names


def test_associate_on_card_equals_cpu(cuda, tmp_path):
    from kmersgwas_tpu_torch.pipeline import scan
    rng = np.random.default_rng(4)
    n, rows, kmer_len = 150, 40_000, 31
    base, names = write_table(tmp_path, rng, n, rows, kmer_len)
    y = np.round(rng.uniform(-8, 8, size=(n, 3)) * 8) / 8
    # a small top-k over many batches: the threshold settles, so the
    # append branches run on the card as well as the fallback
    kw = dict(kmer_len=kmer_len, n_top=8, batch_size=1024,
              count_patterns=True)
    out = [scan.associate(base, names, y, list("abc"), device=d,
                          dtable_cache=str(tmp_path / f"{d}.dtable"), **kw)
           for d in ("cuda", "cpu")]
    assert out[0].n_tested == out[1].n_tested
    assert out[0].n_patterns == out[1].n_patterns
    steps = out[0].steps
    assert steps["fallback"] >= 1 and steps["narrow"] + steps["wide"] >= 1
    for j in range(3):
        np.testing.assert_array_equal(out[0].rows[j], out[1].rows[j])
        np.testing.assert_array_equal(out[0].scores[j], out[1].scores[j])


@pytest.mark.parametrize("lengths", [[10001] * 101, [10001, 0, 5], [0, 0]],
                         ids=["scan", "an_empty_column", "all_empty"])
def test_winners_resolved_on_card_equal_numpy(cuda, lengths):
    """resolve_winners on the card: the rows np.unique gives and, per
    column, the positions RowLookup.take finds; at the scan's 101 x 10,001
    candidates (rows repeated across columns) and with empty columns."""
    from kmersgwas_tpu_torch.pipeline import scan
    rng = np.random.default_rng(len(lengths))
    per_pheno = [(np.zeros(m), rng.choice(1 << 21, size=m, replace=False))
                 for m in lengths]
    all_rows, slots = scan.resolve_winners(per_pheno, cuda)
    cols = [rw for _, rw in per_pheno]
    want = np.unique(np.concatenate(cols))
    assert all_rows.dtype == np.int64
    np.testing.assert_array_equal(all_rows, want)
    positions = scan.RowLookup(want, np.arange(len(want)))
    assert len(slots) == len(cols)
    for slot, rw in zip(slots, cols):
        assert slot.dtype == np.int64
        np.testing.assert_array_equal(slot, positions.take(rw))


def test_traced_table_jobs_on_card_name_the_pinned_ring(cuda, tmp_path):
    """associate and kinship_from_table over a dtable on the card under
    utils.tracing(): every span under the job, the pinned ring's spans
    (ring_alloc and upload on the main thread, ring_wait and ring_copy
    once a batch on the prefetch thread) and the bytes it staged."""
    from kmersgwas_tpu_torch import utils
    from kmersgwas_tpu_torch.pipeline import kinship as km
    from kmersgwas_tpu_torch.pipeline import scan
    rng = np.random.default_rng(9)
    n, rows, kmer_len = 150, 40_000, 31
    base, names = write_table(tmp_path, rng, n, rows, kmer_len)
    y = np.round(rng.uniform(-8, 8, size=(n, 3)) * 8) / 8
    calls = {
        "associate": lambda: scan.associate(
            base, names, y, list("abc"), kmer_len=kmer_len, n_top=8,
            batch_size=4096, device="cuda",
            dtable_cache=str(tmp_path / "s.dtable")),
        "kinship_from_table": lambda: km.kinship_from_table(
            base, device="cuda", maf=0.05, batch_size=4096,
            dtable_cache=str(tmp_path / "k.dtable"))}
    producer = {"feed_read", "feed_put", "ring_wait", "ring_copy"}
    for job, call in calls.items():
        call()                                  # builds the dtable
        with utils.tracing():
            call()
        tr = utils.last_trace()
        (root,) = tr.named(job)
        assert {"ring_alloc", "upload", *producer} <= {s.name
                                                       for s in tr.spans}
        for s in tr.spans:
            assert s.job == root.id, s
            assert (s.thread != root.thread) == (s.name in producer), s
        batches = tr.counters["feed.batches"]
        assert batches >= 2 and len(tr.named("ring_alloc")) == 1
        assert len(tr.named("ring_wait")) == len(tr.named("ring_copy")) \
            == len(tr.named("upload")) == batches
        assert tr.counters["feed.staged_bytes"] > 0


def test_distributed_scan_on_card_equals_cpu_and_associate(cuda, tmp_path):
    """One process of the multi-process scan on the card: the same top-k
    as on the CPU and as `associate`, with K3 launched on every batch."""
    from kmersgwas_tpu_torch.parallel import multihost
    from kmersgwas_tpu_torch.pipeline import scan
    rng = np.random.default_rng(6)
    n, rows, kmer_len = 150, 40_000, 31
    base, names = write_table(tmp_path, rng, n, rows, kmer_len)
    y = np.round(rng.uniform(-8, 8, size=(n, 3)) * 8) / 8
    kw = dict(kmer_len=kmer_len, n_top=8, batch_size=1024,
              count_patterns=True)
    launches = score.score_batch_t_tilemax.launches
    got = multihost.run_distributed_scan(base, names, y, list("abc"),
                                         device="cuda", **kw)
    n_batches = score.score_batch_t_tilemax.launches - launches
    assert n_batches >= got[1] // 1024
    cpu = multihost.run_distributed_scan(base, names, y, list("abc"),
                                         device="cpu", **kw)
    ref = scan.associate(base, names, y, list("abc"), device="cuda", **kw)
    assert got[1:] == cpu[1:] == (ref.n_tested, ref.n_patterns)
    for j in range(3):
        for other in (cpu[0][j], (ref.scores[j], ref.rows[j])):
            np.testing.assert_array_equal(got[0][j][1], other[1])
            np.testing.assert_array_equal(got[0][j][0], other[0])


def test_scan_step_queues_the_next_kernel_before_the_apply(cuda):
    """The scan step one batch deep at the athal1008 shapes (N=1008,
    P=101, top 10001, 2,000,000-row batches, associate's cand_w step): 20
    batches after a 60-batch ramp. Every apply but the last is deferred
    (the last is settled at the flush), every K1 after the first is
    launched inside its score_batch_t_topw range before the previous
    batch's compact_apply begins, and the final top-k equals the same
    stream settled after every step."""
    from torch.profiler import ProfilerActivity, profile
    from kmersgwas_tpu_torch import utils
    from kmersgwas_tpu_torch.ops import scanstep as ss
    from kmersgwas_tpu_torch.pipeline import scan
    n, p, k, rows, w32 = 1008, 101, 10001, 2_000_000, 32
    y = np.random.default_rng(21).normal(size=(n, p)).astype(np.float32)
    yp, ysum = score.prepare_phenotypes(y, 32 * w32, cuda)
    iota = torch.arange(rows, dtype=torch.int32, device=cuda)
    hi0 = torch.zeros(rows, dtype=torch.int32, device=cuda)
    kw = dict(n_used=n, min_count=scan.effective_min_count(n, 0.05, 5),
              cand_k=min(max(256, k // 8), k), tile_rows=scan.TILE_ROWS,
              cand_w=scan.CAND_W, cand_q=scan.CAND_Q)

    def step(st, b):
        planes, pc = gen.gen_planes(rows, w32, 77, b, cuda)
        ss.scan_step_compact(st, planes, pc, iota + b * rows, hi0, yp, ysum,
                             **kw)

    st = ss.init_buffered_state(p, k, scan.BUF_CAP, cuda)
    for b in range(60):
        step(st, b)
    ss.settle(st)
    twin = ss.BufferedTopKState(**{
        f: (v.clone() if torch.is_tensor(v) else v)
        for f, v in ((f, getattr(st, f)) for f in ss.STATE_FIELDS)})
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with utils.tracing():
            for b in range(60, 80):
                step(st, b)
            got = ss.flush_buffered(st)
        torch.cuda.synchronize()
    c = utils.last_trace().counters
    assert c.get("step.deferred") == 19 and c.get("step.settled") == 1, c
    ranges = {}
    for e in prof.events():
        if e.name in ("kgt::score_batch_t_topw", "kgt::compact_apply"):
            ranges.setdefault(e.name, []).append(e.time_range)
    k1, apply = (sorted(ranges[nm], key=lambda r: r.start) for nm in
                 ("kgt::score_batch_t_topw", "kgt::compact_apply"))
    assert len(k1) == len(apply) == 20
    for i in range(1, 20):
        assert k1[i].end <= apply[i - 1].start, i
    for b in range(60, 80):
        step(twin, b)
        ss.settle(twin)
    want = ss.flush_buffered(twin)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("tr", [4, 16, 256, 2048, 4096])
def test_tile_reduce_kernels_equal_plain(cuda, tr):
    """K9: every case of the exp_kernel tool, kernel planes bit-equal to
    the plain versions and to the JAX kernels' numpy functions."""
    from kmersgwas_tpu_torch.tools import exp_kernel
    x = exp_kernel.tie_heavy(104, 32, tr, seed=tr)
    for name in exp_kernel.CASES:
        rec = exp_kernel.run_case(name, x, 32, cuda, timing=False)
        assert rec["equal_plain"] and rec["equal_numpy"], rec


# the plane sets of the tile_reduce kernel's instances (FOLD, TIES, CNT)
REDUCE_PLANE_SETS = [("m1",), ("m1", "cnt"), ("a1",), ("n_eq", "cnt"),
                     ("m2",), ("a2_sum", "cnt"), ("m1", "a1_fold"),
                     ("a1_fold", "cnt"), ("a1_fold", "m2"),
                     ("m1", "a1", "a1_fold", "m2", "a2_sum", "n_eq", "cnt")]


def reduce_plane(kind, p, nt, tr, rng):
    if kind == "ties":
        x = np.round(rng.normal(size=(p, nt, tr)) * 2) + 0.0
    elif kind == "all_equal":
        x = np.repeat(rng.integers(-3, 4, size=(p, nt, 1)), tr, axis=2)
    elif kind == "signed_zero":
        x = -np.abs(np.round(rng.normal(size=(p, nt, tr))))
        x[rng.random((p, nt, tr)) < 0.3] = -0.0
    else:                               # a single maximum, distinct values
        x = np.stack([rng.permutation(tr) for _ in range(p * nt)])
    return torch.from_numpy(x.astype(np.float32).reshape(p, nt * tr))


@pytest.mark.parametrize("tr", [4, 16, 128, 256, 2048, 4096])
def test_tile_reduce_instances_equal_plain(cuda, tr):
    """Every instance of the tile_reduce kernel (each plane set at each TR)
    against tile_reduce_plain, on tie-heavy, all-equal, signed-zero and
    single-maximum planes, with fold_to in {1, 2, 128, TR}."""
    from kmersgwas_tpu_torch.ops import tilereduce as tred
    rng = np.random.default_rng(tr)
    th = torch.tensor([0.5, -1.0, 0.0], device=cuda)
    launches = tred.tile_reduce.launches
    n = 0
    for kind in ("ties", "all_equal", "signed_zero", "single_max"):
        x = reduce_plane(kind, 3, 7, tr, rng)
        xd = x.to(cuda)
        for fold_to in (1, 2, 128, tr):
            want = tred.tile_reduce_plain(x, th.cpu(), n_tiles=7,
                                          fold_to=fold_to)
            for planes in REDUCE_PLANE_SETS:
                got = tred.tile_reduce(xd, th, n_tiles=7, planes=planes,
                                       fold_to=fold_to)
                n += 1
                assert set(got) == set(planes)
                for k in planes:
                    assert torch.equal(got[k].cpu(), want[k]), \
                        (kind, fold_to, planes, k)
    torch.cuda.synchronize()
    assert tred.tile_reduce.launches == launches + n


@pytest.mark.parametrize("tile_rows,w", [(128, 8), (512, 128), (4096, 128)])
@pytest.mark.parametrize("ties", [False, True])
def test_parity_kernel_equals_plain(cuda, tile_rows, w, ties):
    packed, pc, yp, ysum = batch(8192, 1008, 101, 5, cuda, ties=ties)
    kw = dict(n_used=1008, min_count=5, tile_rows=tile_rows, w=w)
    sc = score.scores_t_plain(packed, pc, yp, ysum, n_used=1008, min_count=5)
    q = torch.topk(sc, 16, dim=1).values[:, -1].contiguous()
    before = score.score_batch_t_parity.launches
    for th in (q, torch.full((101,), float("inf"), device=cuda)):
        got = score.score_batch_t_parity(packed, pc, yp, ysum, th, **kw)
        want = score.parity_plain(packed, pc, yp, ysum, th, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    assert score.score_batch_t_parity.launches == before + 2


def select_inputs(n_tiles, p, kind, seed, dev):
    """Tile candidates as K1's tile launch lays them out, (P, 3T) scores
    and lanes and (P, T) counts, made on the card: lanes unique in a column
    (a permutation), no -0.0 and no NaN (the tile launch writes neither).
    kind: random Gaussian scores, dyadic (steps of 1/8: long runs of equal
    scores), tied (every score 2.5), neg_inf (100 finite scores a column,
    the rest -inf, as in a batch of padding)."""
    gen_ = torch.Generator(device=dev).manual_seed(seed)
    n = 3 * n_tiles
    if kind == "tied":
        v = torch.full((p, n), 2.5, device=dev)
    else:
        v = torch.randn((p, n), generator=gen_, device=dev)
        if kind == "dyadic":
            v = torch.round(v * 8) / 8
        elif kind == "neg_inf":
            keep = torch.rand((p, n), generator=gen_, device=dev).argsort(
                dim=1)[:, :100]
            v = torch.full_like(v, float("-inf")).scatter(
                1, keep, v.gather(1, keep))
    v = torch.where(v == 0, 0.0, v).contiguous()
    g = torch.rand((p, n), generator=gen_, device=dev).argsort(dim=1).to(
        torch.int32)
    cnt = torch.randint(0, 4, (p, n_tiles), generator=gen_, device=dev,
                        dtype=torch.int32)
    cnt[::3, n_tiles // 2] = 5                          # a third not ok
    return v, g, cnt


# (n_tiles, P, W, lists, kind, path, fallback): the flagship's 46,875
# candidates, 3 * 2^16, n < W, n = W and n = W + 1 (sort), W from 1 to
# 1024, P 1 to 1013, every score tied and -inf scores (past the stream
# path's 4096-key sort buffer: the radix fallback in every block; within it,
# none), K8's two lists with odd n_tiles on both paths and where one list
# holds more than 1024 and the other fewer than W (sort). fallback None:
# dyadic scores may or may not fill the buffer.
SELECT_CASES = [
    (15_625, 101, 256, 1, "random", "stream", False),
    (1 << 16, 3, 256, 1, "random", "stream", False),
    (50, 7, 256, 1, "random", "sort", False),
    (85, 7, 255, 1, "dyadic", "sort", False),
    (85, 7, 254, 1, "random", "sort", False),
    (15_625, 101, 1, 1, "random", "stream", False),
    (15_625, 101, 64, 1, "dyadic", "stream", None),
    (15_625, 101, 1000, 1, "random", "stream", False),
    (15_625, 101, 1024, 1, "dyadic", "stream", None),
    (15_625, 1, 256, 1, "random", "stream", False),
    (15_625, 1013, 256, 1, "random", "stream", False),
    (2_000, 1013, 256, 1, "dyadic", "stream", None),
    (15_625, 101, 256, 1, "tied", "stream", True),
    (1 << 16, 2, 1024, 1, "tied", "stream", True),
    (15_625, 101, 256, 1, "neg_inf", "stream", True),
    (1_000, 5, 256, 1, "tied", "stream", False),
    (341, 101, 1024, 1, "dyadic", "sort", False),
    (511, 101, 128, 2, "dyadic", "sort", False),
    (1_001, 101, 128, 2, "dyadic", "stream", None),
    (683, 7, 1024, 2, "random", "sort", False),
    (16_383, 101, 128, 2, "random", "stream", False),
    (40_001, 5, 128, 2, "tied", "stream", True)]


@pytest.mark.parametrize("n_tiles,p,w,lists,kind,path,fallback",
                         SELECT_CASES)
def test_select_launch_equals_plain(cuda, n_tiles, p, w, lists, kind, path,
                                    fallback):
    """K1's select launch alone (score.topw_select) against the plain
    select of each list and the guard AND, bit for bit; the kernel picks
    the case's path and its `topw_select.<path>` count rises by one; the
    device tally of the radix fallback rises by one a block where the case
    says so and stays where it says not."""
    from kmersgwas_tpu_torch import utils
    v, g, cnt = select_inputs(n_tiles, p, kind, n_tiles + p + w, cuda)
    assert score.select_path(n_tiles, lists, w) == path
    fb0 = score.select_fallbacks(cuda)
    with utils.tracing():
        got = score.topw_select(v, g, cnt, w, lists)
    torch.cuda.synchronize()
    assert utils.last_trace().counters == {f"topw_select.{path}": 1}
    want = score.topw_select_plain(v, g, cnt, w, lists)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    if fallback is not None:
        assert score.select_fallbacks(cuda) - fb0 == (p * lists if fallback
                                                       else 0)


def test_gen_planes_without_popcounts(cuda):
    planes, _ = gen.gen_planes(1 << 16, 32, 3, 9, cuda)
    alone = gen.gen_planes(1 << 16, 32, 3, 9, cuda, popcount=False)
    assert torch.equal(planes, alone)


@pytest.mark.parametrize("rows,w32,step", [((1 << 16) - 37, 32, 2**32 + 1),
                                          (33, 12, 4), (999, 64, 2**40)])
def test_gen_planes_without_popcounts_equal_plain(cuda, rows, w32, step):
    """popcount=False (its own kernel instance) at ragged rows, w32 != 32
    and a step whose high word is not 0."""
    alone = gen.gen_planes(rows, w32, 3, step, cuda, popcount=False)
    want = gen.gen_planes_plain(torch.arange(rows, device=cuda), w32, 3,
                                step, popcount=False)
    assert torch.equal(alone, want)


def stats_inputs(seed, n, m, p):
    """A kinship-like K, its eigen-system, (p, m, n) 0/1 candidates and
    (p, n) phenotype columns with a genetic part."""
    rng = np.random.default_rng(seed)
    G0 = rng.normal(size=(n, 2 * n))
    K = G0 @ G0.T / (2 * n)
    K = K / np.diag(K).mean()
    w, U = np.linalg.eigh(K)
    genos = (rng.random((p, m, n)) < 0.4).astype(np.float64)
    ys = (np.linalg.cholesky(K + 1e-9 * np.eye(n))
          @ rng.normal(size=(n, p))).T + rng.normal(size=(p, n))
    return K, w, U, genos, ys


def test_remle_and_lmm_on_card_equal_cpu(cuda):
    """REML and lmm_scan_columns in float64 on the card: the CPU's numbers
    within rtol 1e-9 (p_lrt, the log-likelihoods and REML's estimates;
    log10 lambda and beta sit at the golden-section search's float64
    resolution, ~1e-6, as between the port and the JAX package)."""
    from kmersgwas_tpu_torch.stats import emma, lmm
    K, w, U, genos, ys = stats_inputs(21, 120, 60, 3)
    y = ys[0] - ys[0].mean()
    a, b = (emma.remle(y, K, device=d) for d in ("cuda", "cpu"))
    for f in a._fields:
        np.testing.assert_allclose(float(getattr(a, f)),
                                   float(getattr(b, f)), rtol=1e-9)
    ra, rb = (lmm.lmm_scan_columns(genos, ys, w, U, device=d)
              for d in ("cuda", "cpu"))
    for f in ("p_lrt", "logl_alt"):
        np.testing.assert_allclose(getattr(ra, f).cpu().numpy(),
                                   getattr(rb, f).numpy(), rtol=1e-9)
    np.testing.assert_allclose(ra.log10_lambda.cpu().numpy(),
                               rb.log10_lambda.numpy(), rtol=0, atol=1e-5)


def test_device32_on_card_matches_host64(cuda):
    """The packed float32 route on the card against float64 on the CPU, on
    the JAX package's test data shape (tests/test_stats.py:343-369) and at
    its tolerances."""
    from kmersgwas_tpu_torch.stats import lmm
    _, w, U, genos, ys = stats_inputs(17, 96, 40, 3)
    ref = lmm.lmm_scan_columns(genos, ys, w, U, device="cpu")
    bits = np.zeros((3, 40, 128), np.uint8)
    bits[:, :, :96] = genos
    packed = bitplanes.pack_bits_np(bits)
    got = lmm.lmm_scan_columns_packed(packed, ys, w, U, n=96, device="cuda")
    assert got.p_lrt.dtype == torch.float32 and got.p_lrt.is_cuda
    p_ref = ref.p_lrt.numpy()
    p_got = got.p_lrt.cpu().numpy().astype(np.float64)
    np.testing.assert_allclose(p_got, p_ref, atol=2e-3)
    small = p_ref < 0.05
    if small.any():
        np.testing.assert_allclose(np.log10(p_got[small]),
                                   np.log10(p_ref[small]), atol=5e-2)


def test_run_gwas_on_card_equals_cpu(cuda, tmp_path):
    """A small run_gwas on the card against the CPU (host64 on both,
    precision "highest", certify_topk): the artifact comparison of the
    smoke's gwas CLI check; K1 and K7 launched on the card."""
    import pathlib
    import sys
    from kmersgwas_tpu_torch.pipeline import gwas
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    rng = np.random.default_rng(12)
    n = 120
    base, names = write_table(tmp_path, rng, n, 20_000, 31)
    pheno = str(tmp_path / "pheno.tsv")
    chip_smoke.write_gwas_phenotype(pheno, names, seed=3)
    outs = []
    before = (score.score_batch_t_topw.launches,
              kinship.kinship_accumulate.launches)
    for d in ("cuda", "cpu"):
        pathlib.Path(base + ".kinship").unlink(missing_ok=True)
        gwas.run_gwas(gwas.GWASConfig(
            pheno_path=pheno, kmers_table=base, outdir=str(tmp_path / d),
            kmer_len=31, n_kmers=40, n_permutations=10, batch_size=4096,
            score_precision="highest", certify_topk=True, device=d))
        outs.append(chip_smoke.gwas_outputs(str(tmp_path / d)))
    assert score.score_batch_t_topw.launches > before[0]
    assert kinship.kinship_accumulate.launches > before[1]
    chip_smoke.compare_gwas_outputs(*outs)


def test_run_gwas_without_a_card_raises(monkeypatch, tmp_path):
    """device="cuda" without a card raises before any stage runs; no stage
    falls back to the CPU."""
    from kmersgwas_tpu_torch.cli.__main__ import main
    from kmersgwas_tpu_torch.pipeline import gwas
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = gwas.GWASConfig(pheno_path="absent.tsv", kmers_table="absent",
                          outdir=str(tmp_path / "out"), kmer_len=31)
    with pytest.raises(RuntimeError, match="is_available"):
        gwas.run_gwas(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        main(["gwas", "--pheno", "absent.tsv", "--kmers_table", "absent",
              "--outdir", str(tmp_path / "cli"), "-l", "31"])
    assert not (tmp_path / "out").exists()


def smoke():
    import pathlib
    import sys
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
    import chip_smoke
    return chip_smoke


def test_snp_arm_on_card_equals_cpu(cuda, tmp_path):
    """The SNP arm's pieces on the card against the CPU: the planes bit
    for bit, the GRAMMAR scores and their top-N on dyadic phenotypes, the
    SNP kinship within atol 1e-12, and run_snp_arm in both modes
    (the assoc tables' l_mle and p_lrt within chip_smoke.LMM_RTOL)."""
    from kmersgwas_tpu_torch.pipeline import snp_gwas
    from kmersgwas_tpu_torch.snps import assoc, bed
    from kmersgwas_tpu_torch.snps import kinship as snp_kinship
    s = smoke()
    rng = np.random.default_rng(30)
    n, m = 200, 6000
    names = [f"s{i}" for i in range(n)]
    base = str(tmp_path / "snps")
    s.write_snp_bed(base, names, m, seed=3,
                    causal=(123, rng.random(n) < 0.5), device="cuda")
    use = names[::-1][:180]
    pc, pg = (bed.load_bed_planes(base, use, device=d)
              for d in ("cpu", "cuda"))
    for f in ("presence", "nonmiss", "het", "s_gi", "s_gi2", "total"):
        assert torch.equal(getattr(pg, f).cpu(), getattr(pc, f)), f
    y = np.clip(np.round(rng.normal(size=(180, 5)) * 32), -255, 255) / 32
    ic, sc = assoc.most_associated_snps(pc, y, 300, 0.05, 5)
    ig, sg = assoc.most_associated_snps(pg, y, 300, 0.05, 5)
    assert torch.equal(sg.cpu(), sc)
    assert all(np.array_equal(a, b) for a, b in zip(ig, ic))
    np.testing.assert_allclose(
        snp_kinship.emma_kinship_from_bed(base, device="cuda"),
        snp_kinship.emma_kinship_from_bed(base, device="cpu"), rtol=0,
        atol=1e-12)
    G0 = rng.normal(size=(180, 360))
    w, U = np.linalg.eigh(G0 @ G0.T / 360)
    yu = rng.normal(size=(180, 6))
    yt = np.clip(np.round(rng.normal(size=(180, 6)) * 32), -255, 255) / 32
    cols = ["phenotype_value"] + [f"P{i}" for i in range(1, 6)]
    for mode in ("one_step", "two_steps"):
        outs = []
        for d in ("cuda", "cpu"):
            snp_gwas.run_snp_arm(base, str(tmp_path / f"{mode}_{d}"), use,
                                 yu, yt, cols, w, U, mode=mode, n_snps=500,
                                 maf=0.05, mac=5, n_permutations=5,
                                 device=d)
            outs.append(s.gwas_outputs(str(tmp_path / f"{mode}_{d}")))
        a, b = outs
        assert sorted(a) == sorted(b) and "snps/best_pvals" in a
        for f in a:
            la, lb = a[f].decode().splitlines(), b[f].decode().splitlines()
            assert len(la) == len(lb), f
            if f == "snps/best_pvals" or f.startswith("snps/threshold"):
                # -log10 of a best p-value
                for x, z in zip(la, lb):
                    assert np.isclose(float(x.split("\t")[-1]),
                                      float(z.split("\t")[-1]), rtol=1e-6,
                                      atol=0), f
                continue
            for x, z in zip(la[1:] if "assoc" in f else la,
                            lb[1:] if "assoc" in f else lb):
                x, z = x.split("\t"), z.split("\t")
                assert x[:7] == z[:7], f
                for v, u, r in zip(x[7:], z[7:], s.LMM_RTOL):
                    assert np.isclose(float(v), float(u), rtol=r, atol=0), f


def test_emma_on_card_equals_cpu(cuda):
    """emma_ML_LRT and emma_REML_t on the card against the CPU at n=100,
    with phase 20's NaN pattern (blocks, single subsets, a ys row)."""
    from kmersgwas_tpu_torch.stats import emma
    s = smoke()
    rng = np.random.default_rng(31)
    G0 = rng.normal(size=(100, 300))
    K = G0 @ G0.T / 300
    K /= np.diag(K).mean()
    ys, xs, _ = s.emma_inputs(K, 512, 2, seed=32)
    for fn in (emma.emma_ML_LRT, emma.emma_REML_t):
        got, want = (fn(ys, xs, K, device=d) for d in ("cuda", "cpu"))
        for key, w in want.items():
            g, w = got[key].cpu().numpy(), w.numpy()
            assert np.array_equal(np.isnan(g), np.isnan(w)), key
            ok = ~np.isnan(w)
            np.testing.assert_allclose(
                g[ok], w[ok], rtol=1e-6 if key in ("vgs", "ves") else 1e-8,
                atol=1e-8 if key == "stats" else 0, err_msg=key)


def test_calc_gamma_and_emma_kinship_on_card_equal_cpu(cuda, tmp_path):
    from kmersgwas_tpu_torch.stats import emma
    from kmersgwas_tpu_torch.stats.gamma import calc_gamma
    rng = np.random.default_rng(33)
    base, names = write_table(tmp_path, rng, 150, 30_000, 31)
    A = rng.normal(size=(150, 150))
    Vinv = A @ A.T / 150
    got, want = (calc_gamma(base, Vinv, min_count=8, batch_size=4096,
                            device=d) for d in ("cuda", "cpu"))
    assert np.isclose(got, want, rtol=1e-5)
    S = rng.choice([0.0, 0.5, 1.0, np.nan], size=(500, 60),
                   p=[0.45, 0.1, 0.43, 0.02])
    for method in ("additive", "dominant", "recessive"):
        np.testing.assert_allclose(
            emma.emma_kinship(S, method, device="cuda").cpu().numpy(),
            emma.emma_kinship(S, method, device="cpu").numpy(), rtol=0,
            atol=1e-12)
