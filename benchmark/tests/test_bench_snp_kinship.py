"""The SNP kinship cell at CPU sizes: set-up, jobs and a sound run under
its limit with every per-layer metric read, the check at a gap of 0 when
the reference stands in the program's place, a broken timed path over the
limit, and the float32 control over it."""
import json
import time

import pytest

from benchmark import control, harness, run
from benchmark.reference import bedfile
from benchmark.reference import snp_kinship as ref
from benchmark.tests.tiny import tiny_root

CELL = "athal1008_snp.kinship_bed"
SEED = "2147483777"


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


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
    assert res["attempted"] >= 1
    if trace == "1":
        # on the CPU: no card's peaks, so no roofline share
        want = {m["name"] for m in harness.metrics_for(
            harness.load_spec(root), CELL, "per_layer")}
        assert set(res["metrics"]) == want - {"snp_kinship_roofline"}
    else:
        assert set(res["metrics"]) == {"kinship_table_rows_per_s",
                                       "setup_s"}


def the_reference(mp):
    """The reference's own matrix in the program's place."""
    from kmersgwas_tpu_torch.snps import kinship

    def plain(base, *a, device="cuda", **k):
        fam, rows = bedfile.read_bed(base)
        return ref.emma_kinship(rows, len(fam), device).cpu().numpy()
    mp.setattr(kinship, "emma_kinship_from_bed", plain)


def test_the_reference_in_the_programs_place_reads_0(root, capsys,
                                                     monkeypatch):
    the_reference(monkeypatch)
    res = _result(root, capsys)
    assert res["correct"] and res["checks"]["kinship_gap"]["value"] == 0.0


def one_snp_more(mp):
    """The off-diagonal divided by one SNP more than the bed's used."""
    from kmersgwas_tpu_torch.snps import kinship
    emma = kinship.emma_kinship_from_bed

    def wider(base, *a, **k):
        got = emma(base, *a, **k)
        m = bedfile.read_bed(base)[1].shape[0]
        diag = got.diagonal().copy()
        got = got * m / (m + 1)
        got[range(len(diag)), range(len(diag))] = diag
        return got
    mp.setattr(kinship, "emma_kinship_from_bed", wider)


def half_the_bed(mp):
    """Only the bed's first half of SNPs read."""
    from kmersgwas_tpu_torch.core import formats
    rows = formats.iter_bed_rows

    def half(base, chunk):
        m = formats.read_bed_header(base)[1]
        for s, r in rows(base, chunk):
            yield s, r[:max(0, m // 2 - s)]
    mp.setattr(formats, "iter_bed_rows", half)


@pytest.mark.parametrize("fault", [one_snp_more, half_the_bed])
def test_a_broken_timed_path_is_not_correct(root, capsys, monkeypatch,
                                            fault):
    fault(monkeypatch)
    res = _result(root, capsys)
    assert not res["correct"], res["checks"]


def test_the_float32_control_fails(root):
    for line in control.main(["--workload", CELL, "--seeds", "11", "12",
                              "2147483777"], root=root, device="cpu"):
        assert line["fails"], line
