"""The port's tools without a TPU kernel (kmersgwas_tpu_torch.tools.
{prof_step, prof_r5_certify, prof_r5_feedgap, bench_ingest,
at_scale_run}) at tiny sizes on the CPU: each runs to its end and prints
parseable JSON with the JAX tools' fields; bench_ingest's two routes
write the same table bytes, and at_scale_run recovers its planted k-mers
and gives the same results when it reuses its table. The tools run on the card in chip_smoke.py's
phase 24."""
import json
import os
import subprocess
import sys

import pytest

from kmersgwas_tpu_torch.tools import (at_scale_run, prof_r5_certify,
                                       prof_r5_feedgap, prof_step)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


@pytest.mark.parametrize("mode,names", [
    ([], {"score+bmax kernel", "score kernel", "bmax extract c=512"}),
    (["--compact"], {"tilemax kernel"}),
    (["--steady"], {"append path cand_c tile=128",
                    "append path cand_w tile=128"}),
])
def test_prof_step(capsys, mode, names):
    prof_step._cli(mode + ["--device", "cpu", "--rows", "2048", "--n", "100",
                           "--p", "5", "--k", "300", "--iters", "2"])
    lines = json_lines(capsys.readouterr().out)
    assert names <= {ln["name"] for ln in lines}
    assert all(ln["ms"] > 0 and ln["card"] == "cpu" for ln in lines)


def test_prof_r5_certify(tmp_path):
    (line,) = prof_r5_certify.main(1, n_rows=20_000, p=4, k=200,
                                   device="cpu", workdir=str(tmp_path),
                                   batch_size=4096)
    assert line["certified"] == line["columns"] == 4
    assert line["selections"] == 800
    assert 0 <= line["swaps_certified"] <= line["selections"]
    assert json.loads(json.dumps(line)) == line


def test_prof_r5_feedgap(tmp_path, capsys):
    prof_r5_feedgap._cli(["20000", "--batch", "4096", "--device", "cpu",
                          "--workdir", str(tmp_path)])
    lines = json_lines(capsys.readouterr().out)
    assert [ln["pass"][0] for ln in lines] == list("ABCDEF")
    assert all(ln["rows_per_s"] > 0 and ln["rows"] > 0 for ln in lines)


def test_bench_ingest_routes_write_the_same_table(tmp_path):
    outs = {}
    for route in ("native", "numpy"):
        work = tmp_path / route
        proc = subprocess.run(
            [sys.executable, "-m", "kmersgwas_tpu_torch.tools.bench_ingest",
             "--rows", "2e5", "--samples", "6", "--route", route,
             "--workdir", str(work)], cwd=ROOT, capture_output=True,
            text=True, timeout=300)
        assert proc.returncode == 0, proc.stderr
        (line,) = json_lines(proc.stdout)
        assert line["route"] == route and line["n_samples"] == 6
        assert line["table_rows"] == line["master_rows"] > 100_000
        outs[route] = (line, (work / "pop.table").read_bytes())
    assert outs["native"][1] == outs["numpy"][1]
    assert outs["native"][0]["table_rows"] == outs["numpy"][0]["table_rows"]


def test_at_scale_run_reuses_its_table(tmp_path, capsys):
    """Two runs in one work directory: the first generates the table, the
    second reuses it (and its planted truth) and gives the same results."""
    res = []
    for _ in range(2):
        res.append(at_scale_run.main(
            ["--rows", "20000", "--n", "200", "--permutations", "10",
             "--batch_size", "8192", "-k", "200", "--device", "cpu",
             "--workdir", str(tmp_path)]))
    assert "reusing" in capsys.readouterr().err
    for key in ("n_tested", "threshold_5per", "heritability",
                "causal_recovered_5per", "causal_planted"):
        assert res[0][key] == res[1][key], key
    assert res[0]["rows"] == 20000 and res[0]["causal_recovered_5per"] > 0
    assert json.loads((tmp_path / "at_scale_result.json").read_text()) \
        == json.loads(json.dumps(res[1]))
