"""The roofline arithmetic, pinned to the port's kernel table (PERF.md §6):
K1's score GEMM 4.27e11 FLOP and 0.432 ms at 2,097,152 rows, N=1008,
P=101; K7's Gram 1.07e12 op and 0.539 ms at 2^20 rows."""
import pytest

from benchmark import roofline

H100 = roofline.card_peaks("NVIDIA H100 80GB HBM3")


def test_card_peaks():
    assert H100.bf16_flops == 989e12 and H100.int8_ops == 1979e12
    assert H100.hbm_bytes == 3.35e12
    assert roofline.card_peaks("some other card") is None


def test_score_bound_is_k1s():
    ms, by = roofline.score_bound_ms(H100, 2_097_152, 1008, 101, 32)
    assert by == "operations"
    assert 2.0 * 2_097_152 * 1008 * 101 == pytest.approx(4.27e11, rel=2e-3)
    assert ms == pytest.approx(0.432, abs=5e-4)


def test_gram_bound_is_k7s():
    ms, by = roofline.gram_bound_ms(H100, 1 << 20, 1008, 32)
    assert by == "operations"
    assert 2.0 * (1 << 20) * 1008 * 1009 / 2 == pytest.approx(1.07e12,
                                                              rel=5e-3)
    assert ms == pytest.approx(0.539, abs=5e-4)


def test_bytes_bound_where_there_is_little_work():
    ms, by = roofline.score_bound_ms(H100, 1 << 20, 8, 1, 32)
    assert by == "bytes"
    assert ms == pytest.approx((1 << 20) * 132 / 3.35e12 * 1e3)
