"""The SNP cell at CPU sizes: the benchmark's bed writer read back by the
port's reader, the reference against a brute force, a sound run under its
limits with every per-layer metric read, and the faults and the TF32
control over them."""
import json
import time

import numpy as np
import pytest
import torch

from benchmark import control, harness, run
from benchmark.metrics import snp_scores_bound
from benchmark.reference import bedfile
from benchmark.reference import snp as ref
from benchmark.roofline import card_peaks
from benchmark.tests.tiny import tiny_root

CELL = "athal1008_snp.snp_bed"
SEED = "2147483777"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _dubits(rng, m, n):
    return torch.from_numpy(rng.integers(0, 4, (m, n), dtype=np.uint8))


def test_the_writer_read_back_by_the_port(tmp_path):
    from kmersgwas_tpu_torch.core import formats
    rng = np.random.default_rng(5)
    names = [f"s{i}" for i in rng.permutation(23)]
    d = [_dubits(rng, 40, 23), _dubits(rng, 17, 23)]
    base = str(tmp_path / "g")
    with bedfile.BedWriter(base, names, 57) as bw:
        for part in d:
            bw.append(part)
    got_names, got = formats.read_bed(base)
    assert got_names == names == bedfile.read_fam(base)
    np.testing.assert_array_equal(got, torch.cat(d).numpy())
    assert formats.read_bed_header(base) == (names, 57)
    _, rows = bedfile.read_bed(base)
    np.testing.assert_array_equal(
        bedfile.unpack(torch.from_numpy(np.array(rows)), 23), got)
    with open(base + ".bim") as f:
        bim = [ln.rstrip("\n").split("\t") for ln in f]
    assert len(bim) == 57 and all(len(t) == 6 for t in bim)
    assert [t[1] for t in bim] == [f"snp{i:08d}" for i in range(57)]
    chrom = [int(t[0]) for t in bim]
    assert chrom == sorted(chrom) and set(chrom) == set(range(1, 6))
    with pytest.raises(ValueError):
        with bedfile.BedWriter(base, names, 58) as bw:
            bw.append(d[0])


def test_scores_against_a_brute_force():
    rng = np.random.default_rng(9)
    n_fam, m, p = 30, 40, 3
    d = _dubits(rng, m, n_fam).numpy()
    d[:5] = np.where(d[:5] == 1, 1, 0)         # no alt calls: under MAC
    rows = bedfile.pack(torch.from_numpy(d)).numpy()
    cols = rng.choice(n_fam, 25, replace=False)
    y = rng.normal(size=(25, p))
    mc = ref.min_count(25, 0.05, 5)
    got = ref.scores64(rows, torch.from_numpy(cols), n_fam,
                       torch.from_numpy(y), mc, block=7).numpy()
    for i in range(m):
        calls = d[i, cols]
        obs = calls != 1
        g = np.where(calls == 3, 1.0, np.where(calls == 2, 0.5, 0.0))[obs]
        n, sg, sg2 = obs.sum(), g.sum(), (g * g).sum()
        for j in range(p):
            yo = y[obs, j]
            r = n * (yo * g).sum() - sg * yo.sum()
            den = n * (n * sg2 - sg * sg)
            want = r * r / den if den > 0 and mc <= sg <= n - mc else 0.0
            assert got[i, j] == pytest.approx(want, rel=1e-12, abs=1e-12)
    assert not got[:5].any() and got[5:].any()


def test_tf32_values():
    y = torch.tensor([1.0, 1 + 2 ** -11, 1 + 2 ** -10 + 2 ** -12, -3.3])
    q = ref.to_tf32_values(y)
    assert q[0] == 1.0 and q[1] == 1 + 2 ** -10 and q[2] == 1 + 2 ** -10
    assert (q.view(torch.int32) & 0x1FFF == 0).all()
    assert abs(float(q[3]) + 3.3) <= 3.3 * 2 ** -11


def test_the_bound_at_the_cells_size():
    ms, by = snp_scores_bound.bound_ms(card_peaks("NVIDIA H100 80GB HBM3"),
                                       7_000_000, 1008, 101, 32)
    assert by == "operations"
    assert ms == pytest.approx(4.0 * 7e6 * 1008 * 101 / 989e12 * 1e3)
    assert ms == pytest.approx(2.882, abs=5e-4)


def _result(root, capsys, trace="0"):
    rc = run.main(["--workload", CELL, "--seed", SEED, "--seconds", "0.05",
                   "--trace", trace], root=root, device="cpu",
                  t0=time.perf_counter())
    assert rc == 0
    out = capsys.readouterr()
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return json.loads(out.out.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", ["0", "1"])
def test_a_sound_run_is_correct(root, capsys, trace):
    res = _result(root, capsys, trace)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    if trace == "1":
        # on the CPU: no card's peaks, so no roofline share
        want = {m["name"] for m in harness.metrics_for(
            harness.load_spec(root), CELL, "per_layer")}
        assert set(res["metrics"]) == want - {"snp_scores_roofline"}
    else:
        assert set(res["metrics"]) == {"associate_kmers_per_s", "setup_s"}


def index_moved(mp):
    """Column 0's first SNP replaced by one it did not select."""
    from kmersgwas_tpu_torch.snps import assoc
    most = assoc.most_associated_snps

    def moved(*a, **k):
        idx, scores = most(*a, **k)
        free = np.setdiff1d(np.arange(scores.shape[0]), idx[0])
        idx[0] = np.sort(np.concatenate([idx[0][1:], free[-1:]]))
        return idx, scores
    mp.setattr(assoc, "most_associated_snps", moved)


def column_perturbed(mp):
    """Column 2's scores off by one part in 10^3."""
    from kmersgwas_tpu_torch.snps import assoc
    most = assoc.most_associated_snps

    def perturbed(*a, **k):
        idx, scores = most(*a, **k)
        scores[:, 2] *= 1 + 1e-3
        return idx, scores
    mp.setattr(assoc, "most_associated_snps", perturbed)


def half_the_bed(mp):
    """The planes of the bed's second half left as zeros."""
    from kmersgwas_tpu_torch.snps import bed
    load = bed.load_bed_planes

    def half(*a, **k):
        pl = load(*a, **k)
        h = pl.presence.shape[0] // 2
        for t in (pl.presence, pl.het):
            t[h:] = 0
        pl.s_gi[h:] = 0
        pl.s_gi2[h:] = 0
        return pl
    mp.setattr(bed, "load_bed_planes", half)


@pytest.mark.parametrize("fault", [index_moved, column_perturbed,
                                   half_the_bed])
def test_a_broken_timed_path_is_not_correct(root, capsys, monkeypatch,
                                            fault):
    fault(monkeypatch)
    res = _result(root, capsys)
    assert not res["correct"], res["checks"]


def test_the_tf32_control_fails(root):
    for line in control.main(["--workload", CELL, "--seeds", "11", "12",
                              "2147483777"], root=root, device="cpu"):
        assert line["fails"], line
