"""The reading of a traced job: busy time as the union of device events
inside the job's range, each part of an idle gap under the innermost host
range over it, and range shadows on the device left out."""
from types import SimpleNamespace as NS

import pytest
from torch.autograd import DeviceType

from benchmark import trace


def _ev(name, dev, s, e, annotation=False):
    return NS(name=name, device_type=dev, time_range=NS(start=s, end=e),
              is_user_annotation=annotation)


def test_busy_idle_and_device_time():
    cpu, gpu = DeviceType.CPU, DeviceType.CUDA
    events = [
        _ev(trace.JOB, cpu, 0, 100),
        _ev("bench::a", cpu, 10, 40), _ev("kgt::x", cpu, 20, 30),
        _ev("bench::b", cpu, 50, 90),
        _ev("bench::a", gpu, 10, 40, annotation=True),     # a shadow
        _ev("void kgt::k1<13>(float const*)", gpu, -5, 10),
        _ev("void kgt::k1<13>(float const*)", gpu, 95, 100),
        _ev("Memcpy DtoH ", gpu, 96, 99),                   # overlaps k1
        _ev("benchgen::gen(int)", gpu, 200, 300),           # outside
    ]
    tr = trace.summarize(events)
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(15e-6)
    assert tr.device_s == pytest.approx({"kgt::k1<13>": 15e-6,
                                         "Memcpy DtoH ": 3e-6})
    assert tr.idle_s == pytest.approx({"bench::a": 20e-6, "kgt::x": 10e-6,
                                       trace.OUTSIDE: 15e-6,
                                       "bench::b": 40e-6})
    assert tr.device_total_s(exclude="Memcpy") == pytest.approx(15e-6)
    bd = tr.breakdown()
    assert bd["idle_gaps"][0] == ["bench::b", pytest.approx(40e-6)]
    assert len(bd["device_ops"]) == 2


def test_ranges_and_kernel_names():
    assert trace.is_range("bench::feed.wait") and trace.is_range("kgt::_flush")
    assert not trace.is_range("kgt::topw_select_kernel(float const*)")
    assert trace.short_name("void kgt::k<1, 2>(int, float)") == "kgt::k<1, 2>"
