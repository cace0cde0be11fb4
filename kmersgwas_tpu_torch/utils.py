"""Small shared utilities: device checks, stage timing, bounded dispatch,
and the port's one tracing mechanism.

Port of kmersgwas_tpu/utils.py. `drain` waits on a CUDA event recorded
after a step instead of fetching a host scalar.

Tracing. `span(name)` (a context manager or a decorator) names a piece of
work `kgt::<name>`; `count(name, n)` adds to a counter. Both record only
while tracing is on for the calling thread: while torch.profiler records
on it, inside a `tracing()` context, or on a worker thread started by a
traced call that handed it `carry()`'s context (the feed's prefetch
thread). Then a span opens a torch.profiler range where the profiler
records (the device's events and the range lie on one timeline) and
goes, with its parent span, the job span it belongs to and its thread,
into an in-memory recorder; `last_trace()` reads the last job back and
`tracing(path)` writes it out as Chrome-trace JSON. With tracing off a
span enters no profiler range and records nothing: it reads the clock
twice, so that `with span(...) as s` still gives `s.seconds`.
"""
from __future__ import annotations

import functools
import itertools
import json
import os
import sys
import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch.autograd import _profiler_enabled

# A span's torch.profiler range: the profiler's C++ fast range, a fraction
# of record_function's cost under a profiler (same name and nesting)
_FastRange = torch._C._profiler._RecordFunctionFast


def require_device(device) -> torch.device:
    """torch.device for `device`; raises for "cuda" without a usable card.
    There is no silent CPU path: a run asked to use the card uses it or
    fails."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


def step_event(device: torch.device):
    """A CUDA event recorded on the current stream after a step's work, or
    None on the CPU (where every op has finished when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


PREFIX = "kgt::"


class SpanRecord(NamedTuple):
    """One finished span. Times are Unix-epoch nanoseconds, the clock
    torch.profiler's events are converted to (its trace start plus an
    event's offset), so spans and device events lie on one timeline. Each
    is the recorder's anchor (the wall clock read once, when the job span
    opened or the tracing() session started) plus the monotonic clock's
    time since, so every span of a job nests as the monotonic clock
    orders it, whatever the wall clock does meanwhile."""
    name: str                 # without PREFIX
    start_ns: int
    end_ns: int
    id: int
    parent: int | None        # the enclosing span (on a worker thread: the
                              # span that started the worker)
    job: int | None           # the outermost job span it belongs to
    thread: int               # the thread's native id

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9


@dataclass
class Trace:
    """What the recorder holds: spans in the order they ended, counters,
    and the name of each thread that recorded a span."""
    spans: list = field(default_factory=list)
    counters: dict = field(default_factory=dict)
    threads: dict = field(default_factory=dict)

    def named(self, name: str) -> list:
        return [s for s in self.spans if s.name == name]

    def seconds(self, name: str) -> list:
        return [s.seconds for s in self.spans if s.name == name]


class Recorder:
    """The spans and counters of the last traced job. Without a `tracing()`
    context a job span that opens outside any other job empties it; inside
    one, it keeps everything until the context ends."""

    def __init__(self):
        self.lock = threading.Lock()
        self.local = threading.local()  # .stack: open spans; .ctx: carried
        self.ids = itertools.count(1)
        self.sessions = 0               # open tracing() contexts
        self.carriers = 0               # worker threads under carry()
        self.trace = Trace()
        self.reanchor()

    def reanchor(self) -> None:
        """Pair the wall clock with the monotonic clock, once: the spans
        that open from now on are placed on the wall clock from it."""
        self.anchor = (time.time_ns(), time.perf_counter_ns())

    def reset(self) -> None:
        with self.lock:
            self.trace = Trace()

    def stack(self) -> list:
        """The calling thread's open spans, innermost last."""
        st = getattr(self.local, "stack", None)
        if st is None:
            st = self.local.stack = []
        return st

    def context(self) -> tuple:
        """(parent id, job id) a thread's outermost span records under:
        `carried`'s context on a worker thread, else (None, None)."""
        return getattr(self.local, "ctx", None) or (None, None)

    def count(self, name: str, n: int) -> None:
        with self.lock:
            c = self.trace.counters
            c[name] = c.get(name, 0) + n

    def snapshot(self) -> Trace:
        with self.lock:
            t = self.trace
            return Trace(list(t.spans), dict(t.counters), dict(t.threads))


RECORDER = Recorder()


def recording() -> bool:
    """Whether spans and counts are recorded on the calling thread."""
    if _profiler_enabled() or RECORDER.sessions:
        return True
    return bool(RECORDER.carriers) and getattr(
        RECORDER.local, "ctx", None) is not None


class span:
    """`with span(name) as s:` or `@span(name)`: the work inside is
    `kgt::<name>` in torch.profiler and in the recorder while tracing is
    on (module docstring). `job=True` marks a job span: the spans under it
    carry its id. `s.seconds` is the span's duration, traced or not.

    A traced span is three Python calls (init, enter, exit) and C calls:
    under the profiler on the card each Python call costs microseconds,
    and a step opens several spans."""

    __slots__ = ("name", "job", "seconds", "_t0", "_wall", "_rf", "_id",
                 "_parent", "_job_id")

    def __init__(self, name: str, *, job: bool = False):
        self.name = name
        self.job = job
        self.seconds = 0.0
        self._id = None

    def __enter__(self):
        if not recording():
            self._t0 = time.perf_counter_ns()
            return self
        # the range first and the clocks last: the recording's own work
        # lies inside this span's range, not in the enclosing one's
        rf = None
        if _profiler_enabled():
            rf = _FastRange(PREFIX + self.name)
            rf.__enter__()
        self._rf = rf
        rec = RECORDER
        st = rec.stack()
        if st:
            self._parent, self._job_id = st[-1]._id, st[-1]._job_id
        else:
            self._parent, self._job_id = rec.context()
        self._id = next(rec.ids)
        if self.job and self._job_id is None:
            if not rec.sessions:
                rec.reset()
            rec.reanchor()
            self._job_id = self._id
        st.append(self)
        wall, mono = rec.anchor
        self._t0 = time.perf_counter_ns()
        self._wall = wall + (self._t0 - mono)
        return self

    def __exit__(self, *exc) -> bool:
        dt = time.perf_counter_ns() - self._t0
        self.seconds = dt / 1e9
        if self._id is None:
            return False
        RECORDER.stack().pop()
        # the thread's id as threading keeps it: get_native_id() is a
        # system call, tens of us in a sandboxed host
        th = threading.current_thread()
        tid = th.native_id
        t = RECORDER.trace                  # list.append is atomic
        t.spans.append(tuple.__new__(SpanRecord, (
            self.name, self._wall, self._wall + dt, self._id, self._parent,
            self._job_id, tid)))
        if tid not in t.threads:
            t.threads[tid] = th.name
        if self._rf is not None:        # last: the recording's own time
            self._rf.__exit__(None, None, None)   # stays inside the range
        return False

    def __call__(self, fn):
        name, job = self.name, self.job

        @functools.wraps(fn)
        def wrapper(*args, **kw):
            if not recording():
                return fn(*args, **kw)
            with span(name, job=job):
                return fn(*args, **kw)
        return wrapper


def count(name: str, n: int = 1) -> None:
    """Add n to the recorder's counter `name` while tracing is on."""
    if recording():
        RECORDER.count(name, n)


def carry():
    """On a traced thread: the context a worker thread it starts records
    under (`carried`), so the worker's spans carry this job's id; None
    when tracing is off."""
    if not recording():
        return None
    st = RECORDER.stack()
    return (st[-1]._id, st[-1]._job_id) if st else (None, None)


@contextmanager
def carried(ctx):
    """On a worker thread: record under `carry()`'s context. The
    profiler does not see the thread, so its spans go to the recorder
    alone."""
    if ctx is None:
        yield
        return
    with RECORDER.lock:
        RECORDER.carriers += 1
    RECORDER.local.ctx = ctx
    try:
        yield
    finally:
        RECORDER.local.ctx = None
        with RECORDER.lock:
            RECORDER.carriers -= 1


def last_trace() -> Trace:
    """A copy of the recorder: the spans and counters of the last traced
    job (or of the last `tracing()` context)."""
    return RECORDER.snapshot()


@contextmanager
def tracing(path: str | None = None):
    """Trace everything inside (every thread's spans and counters, with no
    profiler needed); at exit, write them to `path` as Chrome-trace JSON
    (write_chrome_trace)."""
    with RECORDER.lock:
        if not RECORDER.sessions:
            RECORDER.trace = Trace()
            RECORDER.reanchor()
        RECORDER.sessions += 1
    try:
        yield
    finally:
        with RECORDER.lock:
            RECORDER.sessions -= 1
        if path:
            write_chrome_trace(path, last_trace())


def write_chrome_trace(path: str, trace: Trace) -> None:
    """Chrome-trace JSON (Perfetto, chrome://tracing): each span a complete
    event on its thread's track, timestamps in Unix-epoch microseconds,
    args its id, parent and job; each counter's total at the last span's
    end."""
    pid = os.getpid()
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
               "args": {"name": name}}
              for tid, name in trace.threads.items()]
    events += [{"name": PREFIX + s.name, "ph": "X", "pid": pid,
                "tid": s.thread, "ts": s.start_ns / 1e3,
                "dur": (s.end_ns - s.start_ns) / 1e3,
                "args": {"id": s.id, "parent": s.parent, "job": s.job}}
               for s in trace.spans]
    end = max((s.end_ns for s in trace.spans), default=time.time_ns())
    events += [{"name": PREFIX + name, "ph": "C", "pid": pid, "ts": end / 1e3,
                "args": {"value": n}}
               for name, n in sorted(trace.counters.items())]
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)


@span("drain")
def drain(event) -> None:
    """Wait until the device has completed the work queued before `event`
    (step_event's). The kinship driver's bounded dispatch waits so on the
    batch a few batches back, so no more than a fixed number of batches'
    inputs stay alive; the scan drivers wait so once, after their last
    step. `event` may be a list (one event per device of a mesh)."""
    for ev in event if isinstance(event, list) else (event,):
        if ev is not None:
            ev.synchronize()


class StageTimer:
    """Accumulates per-stage wall time + item counts; prints to stderr."""

    def __init__(self, name: str, unit: str = "items", quiet: bool = False):
        self.name = name
        self.unit = unit
        self.quiet = quiet
        self.t0 = time.perf_counter()
        self.items = 0
        self._last_report = self.t0

    def add(self, n: int) -> None:
        self.items += n
        now = time.perf_counter()
        if not self.quiet and now - self._last_report > 10.0:
            self._last_report = now
            rate = self.items / max(now - self.t0, 1e-9)
            print(f"[{self.name}] {self.items:,} {self.unit} "
                  f"({rate:,.0f}/s)", file=sys.stderr, flush=True)

    def done(self) -> float:
        dt = time.perf_counter() - self.t0
        if not self.quiet:
            rate = self.items / max(dt, 1e-9)
            print(f"[{self.name}] done: {self.items:,} {self.unit} in "
                  f"{dt:.1f}s ({rate:,.0f}/s)", file=sys.stderr, flush=True)
        return dt
