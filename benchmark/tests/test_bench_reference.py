"""The plain reference against a brute force at tiny sizes: the score row
by row, the kinship by counting matches pair by pair, the table format."""
import os

import numpy as np
import pytest
import torch

from benchmark import compare, inputs
from benchmark.reference import kinship as rk
from benchmark.reference import scan as rs
from benchmark.reference.tablefile import TableWriter, read_table


def _rows(r, w32, seed=3):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-2**31, 2**31 - 1, (r, w32), generator=g,
                         dtype=torch.int64).to(torch.int32)


def test_scores_against_a_brute_force():
    n, w32, p = 70, 4, 3
    planes = _rows(50, w32)
    rng = np.random.default_rng(0)
    y = np.zeros((32 * w32, p))
    y[:n] = rng.normal(size=(n, p))
    n1 = rs.n1_of(planes, n)
    mc = rs.min_count(n, 0.05, 5)
    got = rs.scores64(planes, n1, torch.from_numpy(y), n, mc, block=16)
    bits = [[(int(planes[r, i // 32]) >> (i % 32)) & 1 for i in range(n)]
            for r in range(50)]
    for r in range(50):
        c = sum(bits[r])
        assert n1[r] == c
        for j in range(p):
            yg = sum(y[i, j] * bits[r][i] for i in range(n))
            rr = n * yg - c * y[:n, j].sum()
            den = n * c - c * c
            want = rr * rr / den if den > 0 and mc <= c <= n - mc else 0.0
            assert float(got[r, j]) == pytest.approx(want, rel=1e-12,
                                                     abs=1e-9)


def test_low_precision_scores_round_the_phenotypes():
    planes = _rows(64, 4)
    y = torch.zeros((128, 2))
    y[:100] = torch.randn(100, 2, generator=torch.Generator().manual_seed(1))
    n1 = rs.n1_of(planes, 100)
    lo = rs.scores_lowp(planes, n1.float(), y, 100, 5)
    hi = rs.scores64(planes, n1, y.double(), 100, 5)
    rel = float(((lo.double() - hi).abs() / hi.max()).max())
    assert 1e-4 < rel < 0.3
    assert torch.equal(rs.to_fp8_values(rs.to_fp8_values(y)),
                       rs.to_fp8_values(y))


def test_running_top_k_keeps_the_best_first_seen():
    top = rs.RunningTopK(2, 3, "cpu")
    top.add(torch.tensor([[1., 5.], [3., 5.], [2., 1.]]), torch.arange(3))
    top.add(torch.tensor([[3., 9.], [0., 5.]]), torch.arange(3, 5))
    assert top.v.tolist() == [[3., 3., 2.], [9., 5., 5.]]
    assert top.ids.tolist() == [[1, 3, 2], [3, 0, 1]]


@pytest.mark.parametrize("r,w32", [(37, 4), (130, 8)])
def test_gram_counts_matches(r, w32):
    planes = _rows(r, w32, seed=r)
    g = rk.gram_pm1(planes)
    bits = rs.unpack(planes, torch.int64)
    pm = bits * 2 - 1
    assert torch.equal(g, pm.T @ pm)
    n = 32 * w32 - 5
    k = rk.normalize(g[:n, :n].numpy(), r)
    i, j = 3, 17
    matches = int((bits[:, i] == bits[:, j]).sum())
    assert k[i, j] == matches / r and k[i, i] == 1.0
    k32 = rk.normalize(g[:n, :n].numpy(), r, np.float32)
    assert 0 < compare.kinship_gap(k32, k) < 1e-6


def test_table_round_trip(tmp_path):
    base = os.path.join(tmp_path, "t")
    inputs.write_table(base, 70, 3000, 31, seed=5, device="cpu")
    n, klen, rows = read_table(base)
    assert (n, klen, rows.shape) == (70, 31, (3000, 3))
    assert (np.diff(rows[:, 0].astype(np.int64)) > 0).all()
    assert int(rows[:, 1:].max() >> np.uint64(6)) < 1 << 58   # bits >= 70 zero
    with open(base + ".names") as f:
        assert f.read().split() == [f"acc{i}" for i in range(70)]
    with TableWriter(base + "2", ["a", "b"], 5) as tw:
        tw.append(np.array([7], np.uint64), np.array([[3]], np.uint64))
    assert read_table(base + "2")[2].tolist() == [[7, 3]]


@pytest.mark.gpu
def test_gram_on_the_card_is_exact():
    """Against an int8 product with int32 sums (exact) of the same +-1
    rows, at more rows than bfloat16 could count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    planes = _rows((1 << 20) + 8, 32, seed=9).cuda()
    pm = (rs.unpack(planes, torch.int8) * 2 - 1).contiguous()
    want = torch._int_mm(pm.t().contiguous(), pm).to(torch.int64)
    assert torch.equal(rk.gram_pm1(planes), want)
