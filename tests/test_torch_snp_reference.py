"""The port's SNP prefilter (snps/bed.load_bed_planes, then
snps/assoc.most_associated_snps) against the benchmark's plain reference
(benchmark/reference/snp.py, float64 GRAMMAR-Gamma scores from the bed's
own bytes) on the CPU, on PLINK beds written by the benchmark's own writer
from a seed.

Tolerances: each column's top-N indices are equal (on equal scores the
lower SNP index first, in both). The port's float32 scores lie within
2e-6 of the column's largest float64 score (float32 sums of about a
hundred products, and a difference of two such sums where a score is near
0); on dyadic phenotypes (multiples of 1/32, every sum exact) within the
two float32 roundings of r * r / denominator, 2^-22 of the score itself.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.reference import bedfile
from benchmark.reference import snp as ref
from kmersgwas_tpu_torch.snps import assoc as passoc
from kmersgwas_tpu_torch.snps import bed as pbed

CASES = {
    # het and missing calls, every fam accession used in fam order
    "het_missing": dict(m=300, n_fam=70, n_used=70, shuffle=False,
                        chunk=64, het=0.1, missing=0.05),
    # a fam larger than the used set, the used ones in a shuffled order
    "fam_subset_shuffled": dict(m=300, n_fam=90, n_used=61, shuffle=True,
                                chunk=64, het=0.05, missing=0.05),
    # M not a multiple of the chunk
    "ragged_chunks": dict(m=517, n_fam=45, n_used=40, shuffle=True,
                          chunk=50, het=0.05, missing=0.02),
    # dyadic phenotypes and copied SNP rows: tied scores, lower index first
    "dyadic_ties": dict(m=300, n_fam=64, n_used=50, shuffle=True, chunk=64,
                        het=0.05, missing=0.02, dyadic=True, dup=120),
    # every SNP under the MAC: every score 0, the N lowest indices
    "all_under_mac": dict(m=200, n_fam=50, n_used=40, shuffle=True,
                          chunk=64, het=0.0, missing=0.02, max_alt=3),
}
P, N_BEST, MAF, MAC = 4, 25, 0.05, 5


def make_case(tmp_path, seed, m, n_fam, n_used, shuffle, chunk, het,
              missing, dyadic=False, dup=0, max_alt=None):
    """-> (bed base, used names, (n_used, P) float32 phenotypes)."""
    rng = np.random.default_rng(seed)
    names = [f"acc{i:03d}" for i in range(n_fam)]
    fam = [names[i] for i in rng.permutation(n_fam)] if shuffle else names
    used = ([names[i] for i in rng.choice(n_fam, n_used, replace=False)]
            if shuffle else names[:n_used])
    if max_alt is None:
        alt = rng.uniform(0.02, 0.98, size=(m, 1))
        d = np.where(rng.random((m, n_fam)) < alt, 3, 0).astype(np.uint8)
    else:
        d = np.zeros((m, n_fam), np.uint8)
        for i in range(m):
            d[i, rng.choice(n_fam, rng.integers(0, max_alt + 1),
                            replace=False)] = 3
    u = rng.random((m, n_fam))
    d[u < het + missing] = 2
    d[u < missing] = 1
    if dup:
        d[m - dup:] = d[rng.integers(0, m - dup, size=dup)]
    base = str(tmp_path / "g")
    with bedfile.BedWriter(base, fam, m) as bw:
        bw.append(torch.from_numpy(d))
    y = rng.normal(size=(n_used, P))
    if dyadic:
        y = np.round(y * 32) / 32
    return base, used, y.astype(np.float32)


def reference(base, used, y):
    """-> float64 (M, P) scores and each column's top-N rows."""
    fam, rows = bedfile.read_bed(base)
    pos = {nm: i for i, nm in enumerate(fam)}
    cols = torch.tensor([pos[nm] for nm in used])
    s64 = ref.scores64(rows, cols, len(fam), torch.from_numpy(
        y.astype(np.float64)), ref.min_count(len(used), MAF, MAC), block=37)
    return s64, ref.top_rows(s64, min(N_BEST, s64.shape[0])).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_prefilter_against_the_reference(tmp_path, case):
    kw = CASES[case]
    base, used, y = make_case(tmp_path, 20 + list(CASES).index(case), **kw)
    planes = pbed.load_bed_planes(base, used, device="cpu",
                                  chunk=kw["chunk"])
    idx, scores = passoc.most_associated_snps(planes, y, N_BEST, MAF, MAC)
    s64, want = reference(base, used, y)
    np.testing.assert_array_equal(np.stack(idx), want)
    got, exact = scores.numpy().astype(np.float64), s64.numpy()
    if kw.get("dyadic"):
        np.testing.assert_allclose(got, exact, rtol=2 ** -22, atol=0)
    else:
        scale = np.maximum(exact.max(axis=0), 1e-300)
        assert np.max(np.abs(got - exact) / scale) <= 2e-6
    if case == "all_under_mac":
        assert not exact.any() and not got.any()
        assert (want == np.arange(N_BEST)).all()
    if case == "dyadic_ties":
        # copies tie exactly, and some tie straddles a column's cut
        ties = [np.isin(exact[:, j], exact[want[j], j]).sum() > N_BEST
                for j in range(P)]
        assert any(ties)


def test_the_reference_imports_neither_jax_nor_either_package():
    code = ("import json, sys\n"
            "import benchmark.reference.snp, benchmark.reference.bedfile\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         cwd=os.path.dirname(os.path.dirname(__file__)),
                         text=True, timeout=300, check=True)
    mods = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "torch" in mods
    assert not mods & {"jax", "jaxlib", "kmersgwas_tpu",
                       "kmersgwas_tpu_torch"}, mods
