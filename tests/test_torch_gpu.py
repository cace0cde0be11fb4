"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and the scan on the card against the scan on the CPU.

They skip without CUDA. On a machine with the card (where jax may be
absent, so tests/conftest.py is left out) run:

    python -m pytest tests/test_torch_gpu.py --noconftest -q -p no:cacheprovider

This file imports neither jax nor the JAX package's jax modules.
"""
import numpy as np
import pytest
import torch

from kmersgwas_tpu_torch.ops import bitplanes, score

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def batch(rows, n, p, seed, dev):
    rng = np.random.default_rng(seed)
    n_pad = -(-n // 128) * 128
    bits = rng.integers(0, 2, size=(rows, n)).astype(np.uint8)
    bits[rows - rows // 8 - 5:] = 0                      # padding rows
    padded = np.zeros((rows, n_pad), np.uint8)
    padded[:, :n] = bits
    packed = bitplanes.as_planes(bitplanes.pack_bits_np(padded)).to(dev)
    y = np.round(rng.uniform(-8, 8, size=(n, p)) * 8) / 8   # dyadic: exact
    yp, ysum = score.prepare_phenotypes(y, n_pad, dev)
    return packed, bitplanes.popcount_rows(packed), yp, ysum


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
    with pytest.raises(ValueError, match="16-lane"):
        score.score_batch_t_bmax(packed, pc, yp, ysum, block=8, **kw)


def test_associate_on_card_equals_cpu(cuda, tmp_path):
    from kmersgwas_tpu.core import formats
    from kmersgwas_tpu_torch.pipeline import scan
    rng = np.random.default_rng(4)
    n, rows, kmer_len = 150, 40_000, 31
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
