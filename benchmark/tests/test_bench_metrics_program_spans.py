"""The readers of the program's own spans: over a hand-built traced job
(benchmark/trace.py TraceSummary) and hand-built recorder content
(kmersgwas_tpu_torch.utils), each gives the expected number, and nothing
where its span is absent (as on a program without it)."""
import pytest

from benchmark import harness
from benchmark.trace import TraceSummary

utils = pytest.importorskip("kmersgwas_tpu_torch.utils")


def _read(name, record):
    return harness.reader(harness.ROOT, name)(record)


def _summary(host=None, idle=None):
    return TraceSummary(window_s=2.0, busy_s=0.5, idle_s=idle or {},
                        host_s=host or {})


def _rec(name, start, dur, thread=2):
    return utils.SpanRecord(name, start, start + dur, start, None, 1, thread)


@pytest.fixture
def recorder(monkeypatch):
    """Set the program's recorder content for one test."""
    def put(spans, counters):
        monkeypatch.setattr(utils, "last_trace", lambda: utils.Trace(
            spans=list(spans), counters=dict(counters)))
    return put


def test_winners_s():
    rec = {"trace": _summary(host={"kgt::associate_winners": 0.25})}
    assert _read("associate.winners_s", rec) == 0.25
    assert _read("associate.winners_s", {"trace": _summary()}) is None
    assert _read("associate.winners_s", {}) is None


@pytest.mark.parametrize("name", ["feed.wait_share.scan_table",
                                  "feed.wait_share.kinship_table"])
def test_wait_share(name):
    rec = {"trace": _summary(host={"kgt::feed_wait": 0.5})}
    assert _read(name, rec) == pytest.approx(25.0)
    assert _read(name, {"trace": _summary(host={"bench::feed.wait": 1})}) \
        is None


@pytest.mark.parametrize("name", ["feed.read_ms.scan_table",
                                  "feed.read_ms.kinship_table"])
def test_read_ms(name, recorder):
    ms = 1_000_000
    # three batches and the read past the last one, which is left out
    recorder([_rec("feed_read", 0, 4 * ms), _rec("feed_read", 10 * ms, ms),
              _rec("feed_read", 20 * ms, 3 * ms),
              _rec("feed_read", 30 * ms, ms // 10),
              _rec("feed_put", 5 * ms, 9 * ms)], {"feed.batches": 3})
    assert _read(name, {"trace": _summary()}) == pytest.approx(3.0)
    assert _read(name, {}) is None          # no traced job
    recorder([_rec("feed_put", 0, ms)], {})
    assert _read(name, {"trace": _summary()}) is None


@pytest.mark.parametrize("name", ["feed.stage_ms.scan_table",
                                  "feed.stage_ms.kinship_table"])
def test_stage_ms(name, recorder):
    ms = 1_000_000
    recorder([_rec("ring_wait", 0, 2 * ms), _rec("ring_copy", 2 * ms, ms),
              _rec("ring_wait", 10 * ms, 0), _rec("ring_copy", 10 * ms, ms),
              _rec("ring_wait", 20 * ms, 5 * ms),
              _rec("ring_copy", 25 * ms, 5 * ms)], {})
    assert _read(name, {"trace": _summary()}) == pytest.approx(3.0)
    recorder([_rec("feed_read", 0, ms)], {"feed.batches": 1})
    assert _read(name, {"trace": _summary()}) is None


def test_stage_ms_without_the_recorder(monkeypatch):
    """A program whose utils has no recorder (the parent of the tracing
    change) reads nothing."""
    monkeypatch.delattr(utils, "last_trace")
    assert _read("feed.stage_ms.kinship_table", {"trace": _summary()}) \
        is None
    assert _read("feed.read_ms.scan_table", {"trace": _summary()}) is None


def test_step_idle_share():
    idle = {"kgt::scan_step_compact": 0.01, "kgt::compact_candidates": 0.05,
            "kgt::step_flags": 0.2, "kgt::compact_apply": 0.03,
            "kgt::_flush_merge": 0.01, "kgt::top_k_from_bmax": 0.02,
            "kgt::score_batch_t_bmax": 0.03, "bench::step": 0.5,
            "bench::gen": 0.1, "host: outside any span": 0.2}
    rec = {"trace": _summary(host={"kgt::scan_step_compact": 1.5},
                             idle=idle)}
    assert _read("scan_step.idle_share.fresh", rec) == pytest.approx(17.5)
    parent = {"trace": _summary(host={"kgt::_flush_merge": 0.1},
                                idle={"kgt::_flush_merge": 0.01})}
    assert _read("scan_step.idle_share.fresh", parent) is None
