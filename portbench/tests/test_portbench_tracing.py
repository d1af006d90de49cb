"""The reduction of a trace: busy time is the union of the device's
intervals inside the window, a kernel counts whole where it starts in
the window, and ``device_bounds`` shrinks the window to the device's
first and last operation."""

import types

import pytest
import torch

from portbench.tracing import WINDOW, Trace

CUDA = torch.autograd.DeviceType.CUDA
CPU = torch.autograd.DeviceType.CPU


def _event(name, a, b, device=CUDA):
    return types.SimpleNamespace(
        name=name, device_type=device, is_user_annotation=False,
        time_range=types.SimpleNamespace(start=a, end=b))


def _trace(events):
    tr = Trace()
    tr.prof = types.SimpleNamespace(events=lambda: events)
    return tr


EVENTS = [_event(WINDOW, 0, 1_000_000, CPU),
          _event("staging", 0, 300_000, CPU),
          _event("dblock_nhwc_bf16", 400_000, 500_000),
          _event("copy", 450_000, 600_000),      # overlaps the kernel
          _event("dblock_nhwc_bf16", 700_000, 900_000)]


def test_busy_is_the_union_inside_the_host_window():
    r = _trace(EVENTS).reduce()
    assert r["window_s"] == pytest.approx(1.0)
    assert r["busy_s"] == pytest.approx(0.4)
    assert r["kernels"]["dblock_nhwc_bf16"] == {"count": 2,
                                                "seconds": pytest.approx(0.3)}
    # the longest gap is the host's staging before the first launch
    assert r["breakdown"]["idle_gaps"][0] == ["staging", pytest.approx(0.4)]


def test_device_bounds_leave_out_what_precedes_the_first_operation():
    r = _trace(EVENTS).reduce(device_bounds=True)
    assert r["window_s"] == pytest.approx(0.5)
    assert r["busy_s"] == pytest.approx(0.4)


def test_a_kernel_cut_by_the_window_counts_where_it_starts():
    events = EVENTS + [_event("dblock_nhwc_bf16", 950_000, 1_100_000),
                       _event("dblock_nhwc_bf16", -50_000, 10_000)]
    r = _trace(events).reduce()
    k = r["kernels"]["dblock_nhwc_bf16"]
    assert k["count"] == 3
    assert k["seconds"] == pytest.approx(0.45)
