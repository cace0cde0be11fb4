"""The least time the card needs for the SNP kinship's work, on
benchmark/roofline.bound_ms: the Gram of both passes of every SNP,
2 x (2 M) x n (n + 1) / 2 operations (M SNPs, n fam samples, the entries
on and above the diagonal, the count of roofline.gram_bound_ms) at the
int8 tensor-core peak, against the bed's M x ceil(n / 4) bytes read once
at HBM speed. Each pass's observed calls are 0 or 1, so an integer route
exists for the bulk of the products, and no route needs less: the share
cannot pass 100 %."""
from benchmark import roofline


def bound_ms(peaks, rows: int, n: int) -> tuple[float, str]:
    return roofline.bound_ms(rows * (-(-n // 4)),
                             2.0 * (2 * rows) * n * (n + 1) / 2,
                             peaks.int8_ops, peaks.hbm_bytes)
