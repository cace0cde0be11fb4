"""A whole run at CPU sizes, with the look for a card skipped and the timed
path broken underneath, comes out not correct: once for each fault a cell
can have. A step that leaves its state unchanged; half of each batch left
out; an answer altered where it is produced; in the scan cells, a row
reported twice in a column, pushing its lowest true entry out. (No cell
runs on more than one chip, so none can leave out an exchange between
chips.)"""
import json
import time

import numpy as np
import pytest
import torch

from benchmark import run
from benchmark.tests.tiny import tiny_root


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny_root(str(tmp_path_factory.mktemp("tiny")))


def _result(root, cell, capsys, trace="0"):
    rc = run.main(["--workload", cell, "--seed", "2147483777", "--seconds",
                   "0.05", "--trace", trace], root=root, device="cpu",
                  t0=time.perf_counter())
    assert rc == 0
    out = capsys.readouterr()
    assert out.err.strip().splitlines()[-1].startswith("check ")
    return json.loads(out.out.strip().splitlines()[-1])


def _half(pc):
    pc = pc.clone()
    pc[pc.shape[0] // 2:] = 0          # popcount 0 marks a padding row
    return pc


def scan_state_unchanged(mp):
    from kmersgwas_tpu_torch.ops import scanstep
    mp.setattr(scanstep, "scan_step_compact", lambda st, *a, **k: st)
    mp.setattr(scanstep, "compact_apply", lambda st, *a, **k: st)


def scan_half_batch(mp):
    from kmersgwas_tpu_torch.ops import scanstep
    from kmersgwas_tpu_torch.parallel import sharding
    step = scanstep.scan_step_compact
    mp.setattr(scanstep, "scan_step_compact",
               lambda st, packed, pc, *a, **k: step(st, packed, _half(pc),
                                                    *a, **k))
    shard = sharding.shard_batch

    def half_shards(mesh, arrays, *a, **k):
        packed, pc, lo, hi = arrays
        return shard(mesh, (packed, _half(pc), lo, hi), *a, **k)
    mp.setattr(sharding, "shard_batch", half_shards)


def scan_answer_altered(mp):
    from kmersgwas_tpu_torch.ops import scanstep
    from kmersgwas_tpu_torch.pipeline import scan
    flush = scanstep.flush_buffered

    def altered_flush(st):
        out = flush(st)
        out.row_lo[0, 0] += 1
        return out
    mp.setattr(scanstep, "flush_buffered", altered_flush)
    select = scan.select_candidates

    def altered_select(*a, **k):
        scores, rows, kmers, cert = select(*a, **k)
        kmers[0] = kmers[0].copy()
        kmers[0][0] ^= 1
        return scores, rows, kmers, cert
    mp.setattr(scan, "select_candidates", altered_select)


def _twice(a):
    """Column 0's first entry reported twice, its last one dropped."""
    a[0, 1:] = a[0, :-1].clone() if torch.is_tensor(a) else a[0, :-1].copy()


def scan_row_twice(mp):
    from kmersgwas_tpu_torch.ops import scanstep
    from kmersgwas_tpu_torch.pipeline import scan
    flush = scanstep.flush_buffered

    def twice_flush(st):
        out = flush(st)
        for a in (out.scores, out.row_lo, out.row_hi):
            _twice(a)
        return out
    mp.setattr(scanstep, "flush_buffered", twice_flush)
    select = scan.select_candidates

    def twice_select(*a, **k):
        out = select(*a, **k)
        for col in out[:3]:            # scores, rows, k-mer codes
            col[0] = np.concatenate([col[0][:1], col[0][:-1]])
        return out
    mp.setattr(scan, "select_candidates", twice_select)


def kinship_state_unchanged(mp):
    from kmersgwas_tpu_torch.ops.kinship import KinshipAccumulator

    def add(self, packed, n_rows=None):
        self.n_rows += int(packed.shape[0]) if n_rows is None else n_rows
    mp.setattr(KinshipAccumulator, "add", add)


def kinship_half_batch(mp):
    from kmersgwas_tpu_torch.ops.kinship import KinshipAccumulator
    add = KinshipAccumulator.add

    def half(self, packed, n_rows=None):
        r = int(packed.shape[0]) if n_rows is None else n_rows
        add(self, packed[: r // 2].contiguous())
    mp.setattr(KinshipAccumulator, "add", half)


def kinship_answer_altered(mp):
    from kmersgwas_tpu_torch.ops.kinship import KinshipAccumulator
    fin = KinshipAccumulator.finalize

    def altered(self):
        k = fin(self)
        k[0, 1] += 1e-12
        return k
    mp.setattr(KinshipAccumulator, "finalize", altered)


SCAN = ["athal1008.scan_fresh", "ecoli241.scan_dtable"]
KIN = ["athal1008.kinship_fresh", "athal1008.kinship_dtable"]
FAULTS = ([(c, f) for c in SCAN for f in (scan_state_unchanged,
                                          scan_half_batch,
                                          scan_answer_altered,
                                          scan_row_twice)]
          + [(c, f) for c in KIN for f in (kinship_state_unchanged,
                                           kinship_half_batch,
                                           kinship_answer_altered)])


@pytest.mark.parametrize("cell", SCAN + KIN)
def test_a_sound_run_is_correct(root, cell, capsys):
    res = _result(root, cell, capsys)
    assert res["correct"] and res["failed"] == 0
    assert list(res)[-1] == "checks"


@pytest.mark.parametrize("cell,fault", FAULTS,
                         ids=[f"{c}-{f.__name__}" for c, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(root, cell, fault, capsys,
                                            monkeypatch):
    fault(monkeypatch)
    res = _result(root, cell, capsys)
    assert not res["correct"], res["checks"]


def test_no_card_no_result(capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", SCAN[0], "--seed", "1", "--seconds", "1",
                   "--trace", "0"])
    assert rc != 0 and capsys.readouterr().out == ""
