"""The port's tracing (kmersgwas_tpu_torch.utils span / count / tracing):
the spans of `associate`, `kinship_from_table`, the SNP prefilter and the
SNP kinship with
their parents, job ids and threads, the durations the results report, the counters, one clock
with torch.profiler, no profiler range while tracing is off, and the
Chrome-trace file of `tracing(path)` and the CLI's `--trace`."""
import json
import threading

import numpy as np
import pytest
import torch

from kmersgwas_tpu_torch import utils
from kmersgwas_tpu_torch.cli.__main__ import main as port_cli
from kmersgwas_tpu_torch.core.dtable import DTableReader
from kmersgwas_tpu_torch.ops import scanstep
from kmersgwas_tpu_torch.pipeline import feed
from kmersgwas_tpu_torch.pipeline import kinship as km
from kmersgwas_tpu_torch.pipeline import scan as pscan
from kmersgwas_tpu_torch.snps import assoc as passoc
from kmersgwas_tpu_torch.snps import bed as pbed
from kmersgwas_tpu_torch.snps import kinship as pkinship

from test_pipeline import K, build_population
from test_torch_snp_reference import make_case
from test_torch_scan import dyadic
from test_torch_scanstep import MIN_COUNT, N, _prep, port_batch, stream

# each span's parent: the span open on its thread when it opened, or, on
# the feed's prefetch thread, the span that started the feed
SCAN_PARENTS = {
    "associate_stream": {"associate"},
    "feed_wait": {"associate_stream"},
    "feed_read": {"associate_stream"},
    "feed_put": {"associate_stream"},
    "scan_step": {"associate_stream"},
    "compact_candidates": {"scan_step"},
    "score_batch_t_topw": {"compact_candidates"},
    # a batch is applied by the next step, or by the settle of a
    # checkpoint's or the finalize's read of the state
    "step_flags": {"scan_step", "checkpoint_save", "associate_finalize"},
    "compact_apply": {"scan_step", "checkpoint_save", "associate_finalize"},
    "score_batch_t_bmax": {"compact_apply"},
    "_flush_merge": {"compact_apply"},
    "top_k_from_bmax": {"_flush_merge"},
    "drain": {"associate_stream"},
    "checkpoint_save": {"associate_stream"},
    "associate_finalize": {"associate"},
    "associate_fetch": {"associate"},
    "associate_winners": {"associate_fetch"},
    "fetch_rows": {"associate_fetch"},
    "select_candidates": {"associate"},
}
KINSHIP_PARENTS = {
    "feed_wait": {"kinship_from_table"},
    "feed_read": {"kinship_from_table"},
    "feed_put": {"kinship_from_table"},
    "kinship_add": {"kinship_from_table"},
    "kinship_accumulate": {"kinship_add"},
    "drain": {"kinship_from_table"},
    "checkpoint_save": {"kinship_from_table"},
    "kinship_flush": {"checkpoint_save", "kinship_finalize"},
    "kinship_finalize": {"kinship_from_table"},
}
PRODUCER = {"feed_read", "feed_put", "ring_wait", "ring_copy"}
# the SNP prefilter's spans and their parents (None: opened outside any)
SNP_PARENTS = {"snp_load_planes": None, "bed_read": "snp_load_planes",
               "bed_decode": "snp_load_planes", "snp_scores": None,
               "snp_topn": None}


def check_tree(trace, job: str, parents: dict):
    """The exact set of names; one job span, whose id every span carries;
    each span's parent by name, and inside it in time; the prefetch
    thread's spans on another thread than the rest."""
    by_id = {s.id: s for s in trace.spans}
    assert {s.name for s in trace.spans} == {job, *parents}
    (root,) = trace.named(job)
    assert root.parent is None and root.job == root.id
    main = root.thread
    for s in trace.spans:
        assert s.job == root.id, s
        assert (s.thread != main) == (s.name in PRODUCER), s
        if s is root:
            continue
        p = by_id[s.parent]
        assert p.name in parents[s.name], (s, p)
        assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    return root


def test_associate_spans_and_counters(tmp_path, monkeypatch):
    pop = build_population(tmp_path)
    y = dyadic(1, len(pop["names"]), 4)
    kw = dict(kmer_len=K, n_top=25, maf=0.05, mac=2, batch_size=97,
              device="cpu", dtable_cache=str(tmp_path / "pop.dtable"))
    pscan.associate(pop["base"], pop["names"], y, list("abcd"), **kw)
    counted_in = {}     # the span open where pipeline.scan counted

    def count(name, n=1):
        st = utils.RECORDER.stack()
        counted_in[name] = st[-1].name if st else None
        utils.count(name, n)
    monkeypatch.setattr(pscan, "count", count)
    with utils.tracing():
        res = pscan.associate(pop["base"], pop["names"], y, list("abcd"),
                              checkpoint_path=str(tmp_path / "ck"),
                              checkpoint_every=2, **kw)
    tr = utils.last_trace()
    check_tree(tr, "associate", SCAN_PARENTS)
    assert res.steps["step_s"] == tr.seconds("scan_step")
    for key, name in (("stream", "associate_stream"),
                      ("finalize", "associate_finalize"),
                      ("fetch", "associate_fetch")):
        assert [res.timings[key]] == tr.seconds(name)
    winners = len(np.unique(np.concatenate(res.rows)))
    c = tr.counters
    assert c["fetch.rows"] == winners == len(res.pa_rows)
    assert c["winners.rows"] == winners
    assert c["winners.candidates"] == sum(len(r) for r in res.rows)
    assert counted_in["winners.candidates"] == "associate_winners"
    assert counted_in["winners.rows"] == "associate_winners"
    assert c["feed.batches"] == len(res.steps["step_s"])
    assert c["feed.rows"] == res.n_tested
    assert c["feed.staged_bytes"] > 0
    # the feed's reads: one a batch, and the read that found the end
    assert len(tr.named("feed_read")) == c["feed.batches"] + 1


def test_kinship_spans_and_counters(tmp_path):
    pop = build_population(tmp_path, n_samples=20, n_kmers=400)
    kw = dict(device="cpu", maf=0.05, batch_size=64,
              dtable_cache=str(tmp_path / "pop.dtable"))
    want = km.kinship_from_table(pop["base"], **kw)
    with utils.tracing():
        got = km.kinship_from_table(pop["base"],
                                    checkpoint_path=str(tmp_path / "kin"),
                                    checkpoint_every=2, **kw)
    np.testing.assert_array_equal(got, want)
    tr = utils.last_trace()
    check_tree(tr, "kinship_from_table", KINSHIP_PARENTS)
    c = tr.counters
    batches, saves = c["feed.batches"], len(tr.named("checkpoint_save"))
    assert len(tr.named("kinship_add")) == batches
    assert saves == batches // 2
    assert c["kinship.flushes"] == saves + (batches % 2)
    assert c["feed.rows"] == DTableReader(kw["dtable_cache"]).hdr.n_rows


def test_spans_nest_on_one_clock_while_the_wall_clock_runs_fast(
        tmp_path, monkeypatch):
    """With the wall clock running 1 % fast against the monotonic one, the
    traced kinship job's spans still nest in time: each job reads the
    wall clock once and places every span from the monotonic clock."""
    import time
    pop = build_population(tmp_path, n_samples=20, n_kmers=400)
    kw = dict(device="cpu", maf=0.05, batch_size=64,
              dtable_cache=str(tmp_path / "pop.dtable"))
    km.kinship_from_table(pop["base"], **kw)      # builds the dtable
    wall, mono = time.time_ns, time.perf_counter_ns
    t0 = mono()
    monkeypatch.setattr(utils.time, "time_ns",
                        lambda: wall() + (mono() - t0) // 100)
    with utils.tracing():
        km.kinship_from_table(pop["base"],
                              checkpoint_path=str(tmp_path / "kin"),
                              checkpoint_every=2, **kw)
    check_tree(utils.last_trace(), "kinship_from_table", KINSHIP_PARENTS)


def _snp_prefilter(tmp_path, chunk):
    """The prefilter of a 517-SNP bed over a 45-accession fam (40 used) ->
    (M, chunks, the bed's body bytes)."""
    base, used, y = make_case(tmp_path, 7, m=517, n_fam=45, n_used=40,
                              shuffle=True, chunk=chunk, het=0.05,
                              missing=0.02)
    planes = pbed.load_bed_planes(base, used, device="cpu", chunk=chunk)
    passoc.most_associated_snps(planes, y, 25, 0.05, 5)
    return 517, -(-517 // chunk), 517 * (-(-45 // 4))


def test_snp_prefilter_spans_and_counters(tmp_path):
    """`snp_load_planes` holds one `bed_read` and one `bed_decode` a chunk,
    in that order; `snp_scores` and `snp_topn` follow it; the counters are
    the bed's SNPs, chunks and body bytes."""
    with utils.tracing():
        m, chunks, body = _snp_prefilter(tmp_path, chunk=50)
    tr = utils.last_trace()
    by_id = {s.id: s for s in tr.spans}
    assert {s.name for s in tr.spans} == set(SNP_PARENTS)
    for s in tr.spans:
        parent = by_id[s.parent].name if s.parent else None
        assert parent == SNP_PARENTS[s.name], s
        if s.parent:
            p = by_id[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, (s, p)
    (load,) = tr.named("snp_load_planes")
    inner = sorted((s for s in tr.spans if s.parent == load.id),
                   key=lambda s: s.start_ns)
    assert [s.name for s in inner] == ["bed_read", "bed_decode"] * chunks
    (scores,) = tr.named("snp_scores")
    (topn,) = tr.named("snp_topn")
    assert load.end_ns <= scores.start_ns <= scores.end_ns <= topn.start_ns
    assert tr.counters == {"snp.rows": m, "snp.chunks": chunks,
                           "snp.bed_bytes": body}


def test_snp_prefilter_untraced_records_nothing(tmp_path, monkeypatch):
    """With tracing off the prefilter enters no profiler range and leaves
    the recorder as it was."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range entered with tracing off")
    monkeypatch.setattr(utils, "_FastRange", refuse)
    before = utils.last_trace()
    assert not utils.recording()
    _snp_prefilter(tmp_path, chunk=64)
    assert utils.last_trace() == before


def test_snp_kinship_spans_and_counters(tmp_path):
    """`snp_kinship` holds one `bed_read`, `bed_decode` and `snp_gram` a
    chunk, in that order; the counters are the bed's SNPs, chunks and body
    bytes, and the SNPs with an observed call (the all-missing one left
    out)."""
    from test_torch_snp_kinship import make_bed
    m, n, chunk = 203, 41, 50
    base, _ = make_bed(tmp_path, 8, m=m, n=n, het=0.05, missing=0.05,
                       all_missing=True)
    with utils.tracing():
        pkinship.emma_kinship_from_bed(base, chunk, device="cpu")
    tr = utils.last_trace()
    chunks = -(-m // chunk)
    assert {s.name for s in tr.spans} == {"snp_kinship", "bed_read",
                                          "bed_decode", "snp_gram"}
    (root,) = tr.named("snp_kinship")
    assert root.parent is None
    inner = sorted((s for s in tr.spans if s is not root),
                   key=lambda s: s.start_ns)
    assert [s.name for s in inner] == ["bed_read", "bed_decode",
                                       "snp_gram"] * chunks
    for s in inner:
        assert s.parent == root.id
        assert root.start_ns <= s.start_ns and s.end_ns <= root.end_ns, s
    assert tr.counters == {"snp_kinship.rows": m,
                           "snp_kinship.chunks": chunks,
                           "snp_kinship.bed_bytes": m * (-(-n // 4)),
                           "snp_kinship.used": m - 1}


def test_a_job_span_under_the_profiler_fills_the_recorder():
    """With no tracing() context, a traced job span empties the recorder
    and leaves its own spans there; a job run with tracing off leaves it
    as it was."""
    from torch.profiler import ProfilerActivity, profile

    @utils.span("job_a", job=True)
    def job():
        with utils.span("piece"):
            utils.count("n", 2)
    with profile(activities=[ProfilerActivity.CPU]):
        job()
    first = utils.last_trace()
    assert [s.name for s in first.spans] == ["piece", "job_a"]
    assert first.counters == {"n": 2}
    job()
    assert utils.last_trace() == first


def test_spans_lie_on_the_profilers_clock():
    """Each recorder span of a fallback step (queued, then applied by the
    settle) lies within 1 ms of its torch.profiler range (the trace's
    start plus the range's offset)."""
    from torch.profiler import ProfilerActivity, profile
    y, batches = stream(33, p=3, n_batches=1)
    yp, ysum = (torch.from_numpy(a) for a in _prep(y))
    st = scanstep.init_buffered_state(3, 16, buf_cap=24, device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with utils.span("clock_job", job=True):
            scanstep.scan_step_compact(
                st, *port_batch(batches[0]), yp, ysum, n_used=N,
                min_count=MIN_COUNT, cand_k=12, tile_rows=16, cand_w=8,
                cand_q=4)
            scanstep.settle(st)
    t0 = prof.profiler.kineto_results.trace_start_ns()
    ranges = sorted((e for e in prof.events()
                     if e.name.startswith(utils.PREFIX)),
                    key=lambda e: (e.name, e.time_range.start))
    spans = sorted(utils.last_trace().spans,
                   key=lambda s: (utils.PREFIX + s.name, s.start_ns))
    assert [e.name for e in ranges] == [utils.PREFIX + s.name for s in spans]
    assert len(spans) >= 9
    for e, s in zip(ranges, spans):
        assert abs(t0 + e.time_range.start * 1e3 - s.start_ns) < 1e6, s
        assert abs(t0 + e.time_range.end * 1e3 - s.end_ns) < 1e6, s


def test_tracing_off_enters_no_profiler_range(monkeypatch):
    """With no profiler and no tracing(), a span enters no profiler range
    (record_function, or the profiler's fast range) and records nothing,
    yet times itself; a whole step runs so."""
    def refuse(*a, **k):
        raise AssertionError("a profiler range entered with tracing off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(utils, "_FastRange", refuse)
    before = utils.last_trace()
    assert not utils.recording()
    with utils.span("off") as s:
        utils.count("off", 1)
    assert s.seconds > 0
    y, batches = stream(33, p=3, n_batches=2)
    yp, ysum = (torch.from_numpy(a) for a in _prep(y))
    st = scanstep.init_buffered_state(3, 16, buf_cap=24, device="cpu")
    for b in batches:
        scanstep.scan_step_compact(
            st, *port_batch(b), yp, ysum, n_used=N, min_count=MIN_COUNT,
            cand_k=12, tile_rows=16, cand_w=8, cand_q=4)
    assert utils.last_trace() == before


class _Event:
    def __init__(self, done):
        self.done = done

    def query(self):
        return self.done

    def synchronize(self):
        self.done = True


def test_pinned_ring_stage_spans_and_stalls():
    """PinnedRing.stage on a worker thread that carries a traced job:
    `ring_wait` then `ring_copy` a batch, and a stall counted where the
    slot's copy had not finished (slots of host tensors and a stand-in
    event: pinned memory needs a card)."""
    ring = feed.PinnedRing.__new__(feed.PinnedRing)
    ring._free = __import__("queue").Queue()
    slots = []
    for done in (False, True):
        slot = feed._Slot.__new__(feed._Slot)
        slot.tensors = (torch.zeros(8, dtype=torch.int32),)
        slot.event = _Event(done)
        slots.append(slot)
        ring._free.put(slot)
    a = np.arange(5, dtype=np.uint32)
    with utils.tracing():
        with utils.span("ring_job", job=True):
            ctx = utils.carry()

            def worker():
                with utils.carried(ctx):
                    ring.stage(a)
                    ring.stage(a + 5)
            t = threading.Thread(target=worker)
            t.start()
            t.join(timeout=60)
    assert not t.is_alive()
    tr = utils.last_trace()
    assert [s.name for s in tr.spans] == ["ring_wait", "ring_copy"] * 2 \
        + ["ring_job"]
    (job,) = tr.named("ring_job")
    assert all(s.job == job.id and s.parent == job.id and
               s.thread != job.thread for s in tr.spans[:-1])
    assert tr.counters == {"ring.stalls": 1}
    np.testing.assert_array_equal(slots[1].tensors[0][:5].numpy(),
                                  np.arange(5, 10))


def test_tracing_writes_a_chrome_trace(tmp_path):
    path = tmp_path / "t.json"
    with utils.tracing(str(path)):
        with utils.span("outer", job=True):
            with utils.span("inner"):
                utils.count("things", 3)
    events = json.loads(path.read_text())["traceEvents"]
    x = {e["name"]: e for e in events if e["ph"] == "X"}
    assert set(x) == {"kgt::outer", "kgt::inner"}
    o, i = x["kgt::outer"], x["kgt::inner"]
    assert o["ts"] <= i["ts"] and i["ts"] + i["dur"] <= o["ts"] + o["dur"]
    assert i["args"]["parent"] == o["args"]["id"] == i["args"]["job"]
    names = [e for e in events if e["ph"] == "M"]
    assert [e["tid"] for e in names] == [o["tid"]]
    (c,) = [e for e in events if e["ph"] == "C"]
    assert c["name"] == "kgt::things" and c["args"] == {"value": 3}


@pytest.mark.parametrize("command", ["associate", "kinship", "gwas"])
def test_cli_trace_flag(tmp_path, capsys, command):
    """`--trace PATH` writes the command's spans: one job span for each job
    the command runs (gwas: the kinship, then the scan), each span under
    one of them."""
    pop = build_population(tmp_path, n_samples=40, n_kmers=400)
    path = tmp_path / "trace.json"
    pheno = str(tmp_path / "pheno.tsv")
    argv = {"associate": ["associate", "-p", pheno, "-b", "r", "-o",
                          str(tmp_path), "--kmers_table", pop["base"],
                          "--kmer_len", str(K), "-n", "10", "--mac", "2",
                          "--batch_size", "97"],
            "kinship": ["kinship", "-t", pop["base"], "--maf", "0.05"],
            "gwas": ["gwas", "--pheno", pheno, "--kmers_table", pop["base"],
                     "--outdir", str(tmp_path / "g"), "-l", str(K), "-k",
                     "10", "--permutations", "2", "--mac", "2",
                     "--batch_size", "97"]}[command]
    port_cli(argv + ["--device", "cpu", "--trace", str(path)])
    capsys.readouterr()
    events = json.loads(path.read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    want = {"associate": ["kgt::associate"],
            "kinship": ["kgt::kinship_from_table"],
            "gwas": ["kgt::kinship_from_table", "kgt::associate"]}[command]
    jobs = sorted((e for e in spans if e["name"] in want),
                  key=lambda e: e["ts"])
    assert [e["name"] for e in jobs] == want
    assert {e["args"]["job"] for e in spans} == {e["args"]["id"]
                                                 for e in jobs}
