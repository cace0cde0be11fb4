"""The least time the card needs for the SNP arm's score work, on
benchmark/roofline.bound_ms: the two products of every SNP's doses and
observed calls with the phenotypes, 4 M N P FLOP (M SNPs, N used samples,
P columns) at the bf16 tensor-core peak, against the three planes (M, W32)
int32 read once at HBM speed. No route needs less, whatever computes the
score, so the share cannot pass 100 %."""
from benchmark import roofline


def bound_ms(peaks, rows: int, n_used: int, p: int,
             w32: int) -> tuple[float, str]:
    return roofline.bound_ms(3 * rows * w32 * 4, 4.0 * rows * n_used * p,
                             peaks.bf16_flops, peaks.hbm_bytes)
