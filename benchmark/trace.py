"""A traced job: torch.profiler around one whole job, read into the
device's busy time, its idle time by what the host was doing (each part of
a gap under the innermost host range over it), and the device time by
operation.

Host spans are the profiler ranges of the benchmark's drivers (`bench::`)
and of the port (`kgt::`). A device event is a kernel, copy or fill the
device ran; the device-side shadows of the ranges carry the same time again
and are left out. Every interval is clipped to the job's own range,
`bench::job`, which is the traced window.
"""
from __future__ import annotations

import bisect
import re
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch

JOB = "bench::job"
_RANGE = re.compile(r"(bench|kgt)::[\w.]+")
TOP = 10


def is_range(name: str) -> bool:
    """A range's name, not a kernel's: `kgt::topw_select_kernel(...)`
    carries a parameter list, a range is a bare dotted name."""
    return _RANGE.fullmatch(name) is not None


def short_name(name: str) -> str:
    """A kernel's name without its parameter list and return type."""
    name = name.split("(")[0]
    return (name[5:] if name.startswith("void ") else name)[:200]


@dataclass
class TraceSummary:
    window_s: float
    busy_s: float                            # union of device intervals
    device_s: dict = field(default_factory=dict)   # short name -> seconds
    idle_s: dict = field(default_factory=dict)     # host span -> seconds
    host_s: dict = field(default_factory=dict)     # host span -> seconds

    def device_total_s(self, exclude: str = "") -> float:
        """Summed device time, leaving out names containing `exclude`."""
        return sum(s for n, s in self.device_s.items()
                   if not (exclude and exclude in n))

    def breakdown(self) -> dict:
        def top(d):
            return [[n, s] for n, s in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_s),
                "idle_gaps": top(self.idle_s)}


def _union(intervals):
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


OUTSIDE = "host: outside any span"


def _attribute(ranges, starts, g0: float, g1: float, idle: dict) -> None:
    """Add the idle gap [g0, g1] to `idle`, each part of it under the
    innermost host range over that part (looking back over the 64 ranges
    that started last before the gap's end)."""
    i = bisect.bisect_left(starts, g1)
    near = [r for r in ranges[max(0, i - 64):i] if r[1] > g0]
    cuts = sorted({g0, g1, *(x for s, e, _ in near for x in (s, e)
                             if g0 < x < g1)})
    for a, b in zip(cuts, cuts[1:]):
        t = 0.5 * (a + b)
        over = [(e - s, name) for s, e, name in near if s <= t <= e]
        lab = min(over)[1] if over else OUTSIDE
        idle[lab] = idle.get(lab, 0.0) + (b - a) * 1e-6


def summarize(events) -> TraceSummary:
    """Read a profile's events (torch.profiler's `prof.events()`, or any
    objects with name, device_type, time_range.start/end in us)."""
    from torch.autograd import DeviceType
    jobs = [e for e in events
            if e.name == JOB and e.device_type == DeviceType.CPU]
    if not jobs:
        raise ValueError(f"no {JOB} range in the trace")
    w0, w1 = jobs[0].time_range.start, jobs[0].time_range.end
    dev, ranges = [], []
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s:
            continue
        if e.device_type == DeviceType.CUDA:
            if not is_range(e.name) and not getattr(
                    e, "is_user_annotation", False):
                dev.append((s, t, e.name))
        elif is_range(e.name) and e.name != JOB:
            ranges.append((s, t, e.name))
    per = {}
    for s, t, n in dev:
        k = short_name(n)
        per[k] = per.get(k, 0.0) + (t - s) * 1e-6
    busy = _union([(s, t) for s, t, _ in dev])
    ranges.sort()
    starts = [r[0] for r in ranges]
    idle = {}
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    for g0, g1 in zip(edges[::2], edges[1::2]):
        if g1 > g0:
            _attribute(ranges, starts, g0, g1, idle)
    host = {}
    for s, t, n in ranges:
        host[n] = host.get(n, 0.0) + (t - s) * 1e-6
    return TraceSummary(window_s=(w1 - w0) * 1e-6,
                        busy_s=sum(e - s for s, e in busy) * 1e-6,
                        device_s=per, idle_s=idle, host_s=host)


@contextmanager
def span(name: str):
    """A host range the trace reads (`bench::` + name); costs one enter and
    one exit call when no profiler runs."""
    with torch.autograd.profiler.record_function("bench::" + name):
        yield


def traced_job(job, index: int):
    """Run job(index) under the profiler -> (its rows, TraceSummary)."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with torch.autograd.profiler.record_function(JOB):
            rows = job(index)
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return rows, summarize(prof.events())


def _spanned(fn, label: str):
    def wrapper(*args, **kw):
        with span(label):
            return fn(*args, **kw)
    return wrapper


def _iter_spanned(fn, label: str):
    """fn returns an iterator; each next() of it runs in the span."""
    def wrapper(*args, **kw):
        it = iter(fn(*args, **kw))

        def items():
            while True:
                with span(label):
                    try:
                        item = next(it)
                    except StopIteration:
                        return
                yield item
        return items()
    return wrapper


@contextmanager
def patched_spans(targets):
    """Spans around the program's layer calls, for the traced job only:
    each (owner, attribute, label, returns_iterator) in `targets` is
    replaced by a wrapper that runs it inside `bench::<label>`, and put
    back on exit. The program looks these up by attribute at call time."""
    saved = []
    try:
        for owner, attr, label, is_iter in targets:
            fn = getattr(owner, attr)
            saved.append((owner, attr, fn))
            setattr(owner, attr, (_iter_spanned if is_iter else _spanned)(
                fn, label))
        yield
    finally:
        for owner, attr, fn in reversed(saved):
            setattr(owner, attr, fn)
