"""The port's SNP EMMA kinship (snps/kinship.emma_kinship_from_bed) against
the benchmark's plain reference (benchmark/reference/snp_kinship.py, the
four products of emma_kinship.cpp written out, from the bed's own bytes)
and the reference against the JAX package's function, on the CPU, on
seeded random beds written by the benchmark's own writer.

Tolerance: atol 1e-12 on every entry. The port folds the four products
into one and the three sum in other orders, so they agree to float64
rounding (~1e-16 at these sizes), not bit for bit.

The same test holds the faults that the cell's check
(benchmark/drivers/bed_kinship.py, `compare.kinship_gap` against the
limit of benchmark/limits/athal1008_snp.kinship_bed.json) must read over
its limit, and the cell's least time (benchmark/metrics/
snp_kinship_bound.py) to the hand count.
"""
import json
import os

import numpy as np
import pytest
import torch

from benchmark import compare
from benchmark.metrics import snp_kinship_bound
from benchmark.reference import bedfile
from benchmark.reference import snp_kinship as ref
from benchmark.roofline import card_peaks
from kmersgwas_tpu.snps import kinship as jkinship
from kmersgwas_tpu_torch.snps import kinship as pkinship

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
with open(os.path.join(ROOT, "benchmark", "limits",
                       "athal1008_snp.kinship_bed.json")) as _f:
    LIMIT = json.load(_f)["kinship_gap"]

BEDS = {
    # het and missing calls
    "het_missing": dict(m=300, n=64, chunk=64, het=0.1, missing=0.05),
    # one SNP with no observed call: dropped, and not counted
    "all_missing_snp": dict(m=200, n=48, chunk=64, het=0.05, missing=0.05,
                            all_missing=True),
    # one SNP with a single genotype everywhere
    "monomorphic_snp": dict(m=200, n=48, chunk=64, het=0.05, missing=0.05,
                            monomorphic=True),
    # n not a multiple of 4: the last bed byte holds padding bits
    "n_not_multiple_of_4": dict(m=250, n=45, chunk=64, het=0.05,
                                missing=0.03),
    # chunk sizes that split the bed unevenly
    "uneven_chunks": dict(m=517, n=37, chunk=50, het=0.05, missing=0.02),
}
FAULTS = ("missing_as_0", "float32", "all_missing_counted")
CASES = [*BEDS, *(f"fault_{f}" for f in FAULTS), "bound"]


def make_bed(tmp_path, seed, m, n, het, missing, all_missing=False,
             monomorphic=False, **_):
    """A bed of m SNPs over n samples (each SNP's alt frequency uniform in
    0.02-0.98), SNP 7 all missing and SNP 11 all homozygous alt on
    request -> (base, (m, n) uint8 dubits)."""
    rng = np.random.default_rng(seed)
    alt = rng.uniform(0.02, 0.98, size=(m, 1))
    d = np.where(rng.random((m, n)) < alt, 3, 0).astype(np.uint8)
    u = rng.random((m, n))
    d[u < het + missing] = 2
    d[u < missing] = 1
    if all_missing:
        d[7] = 1
    if monomorphic:
        d[11] = 3
    base = str(tmp_path / "g")
    with bedfile.BedWriter(base, [f"s{i}" for i in range(n)], m) as bw:
        bw.append(torch.from_numpy(d))
    return base, d


def reference(base, dtype=torch.float64):
    fam, rows = bedfile.read_bed(base)
    return ref.emma_kinship(rows, len(fam), "cpu", dtype=dtype,
                            block=37).numpy()


def fault_gap(tmp_path, fault):
    """The check's reading of a faulty answer on a bed with het, missing
    and one all-missing SNP."""
    kw = dict(BEDS["all_missing_snp"])
    base, d = make_bed(tmp_path, 40, **kw)
    exact = reference(base)
    if fault == "missing_as_0":
        # every missing call read as a homozygous call of the first allele
        bad = str(tmp_path / "bad")
        names = bedfile.read_fam(base)
        with bedfile.BedWriter(bad, names, d.shape[0]) as bw:
            bw.append(torch.from_numpy(np.where(d == 1, 0, d)))
        got = pkinship.emma_kinship_from_bed(bad, kw["chunk"], device="cpu")
    elif fault == "float32":
        got = reference(base, torch.float32)
    else:
        # the all-missing SNP counted in the normalizer
        got = pkinship.emma_kinship_from_bed(base, kw["chunk"], device="cpu")
        used, m = d.shape[0] - 1, d.shape[0]
        got = got * used / m
        np.fill_diagonal(got, 1.0)
    return compare.kinship_gap(got, exact)


@pytest.mark.parametrize("case", CASES)
def test_snp_kinship_against_the_reference(tmp_path, case):
    if case == "bound":
        ms, by = snp_kinship_bound.bound_ms(
            card_peaks("NVIDIA H100 80GB HBM3"), 7_000_000, 1135)
        assert by == "operations"
        assert ms == pytest.approx(2 * 2 * 7e6 * 1135 * 1136 / 2
                                   / 1979e12 * 1e3)
        assert ms == pytest.approx(9.12, abs=5e-3)
        return
    if case.startswith("fault_"):
        gap = fault_gap(tmp_path, case[len("fault_"):])
        assert gap > LIMIT, gap
        return
    kw = BEDS[case]
    base, d = make_bed(tmp_path, 30 + CASES.index(case), **kw)
    want = reference(base)
    for chunk in (kw["chunk"], 1 << 15):
        got = pkinship.emma_kinship_from_bed(base, chunk, device="cpu")
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        assert compare.kinship_gap(got, want) <= LIMIT
    np.testing.assert_allclose(jkinship.emma_kinship_from_bed(base), want,
                               rtol=0, atol=1e-12)
    assert np.array_equal(np.diag(want), np.ones(kw["n"]))
    if case == "all_missing_snp":
        # the same matrix as the bed without that SNP
        kept = str(tmp_path / "kept")
        with bedfile.BedWriter(kept, bedfile.read_fam(base),
                               d.shape[0] - 1) as bw:
            bw.append(torch.from_numpy(np.delete(d, 7, axis=0)))
        np.testing.assert_allclose(reference(kept), want, rtol=0,
                                   atol=1e-12)
