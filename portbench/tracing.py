"""A ``torch.profiler`` trace of a run's steady slice, reduced to what the
per-layer metrics and the result's ``breakdown`` read.

The idle arithmetic, 1 - (device time of the kernels) / wall, and the
port's kernel names are copied from ``gansynth_tpu_torch/utils/
profiling.py`` at commit 267e540 (``_trace``, ``PORT_KERNELS``): K1, K2
and K3 are found by the names of their device functions. Here the device
time is the union of the device's intervals, so overlapping streams are
not counted twice, and it is clipped to the traced window: the span
``portbench.window`` that the driver opens around the slice on the host.
A kernel's launches and seconds count whole kernels that start in the
window, so that one cut at an edge does not count as a short launch.
Each idle gap is labelled with the innermost host event that was running
at its middle.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Tuple

PORT_KERNELS = {"synthesis_spectrum": "synthesis_spectrum_gather",
                "conv3x3": "conv3x3_nhwc_", "dblock": "dblock_nhwc_"}
WINDOW = "portbench.window"


def warm_up() -> None:
    """Starts and stops the profiler once. Its first start in a process
    initialises CUPTI, which took about 9 s on an H100 and holds up every
    other thread meanwhile: a traced run pays it in its set-up, not in
    its window."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        pass


class Trace:
    """:meth:`start` and :meth:`stop` trace what runs between them (the
    host span ``portbench.window`` marks the window); :meth:`reduce`
    then gives the reduction."""

    def __init__(self):
        self.prof = None

    def start(self, span: bool = True) -> None:
        """Starts the profiler, and the window with it unless ``span`` is
        False (then :meth:`enter_window` opens it)."""
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()
        self._span = None
        if span:
            self.enter_window()

    def enter_window(self) -> None:
        from torch.profiler import record_function

        self._span = record_function(WINDOW)
        self._span.__enter__()

    def exit_window(self) -> None:
        self._span.__exit__(None, None, None)
        self._span = None

    def stop(self) -> None:
        if self._span is not None:
            self.exit_window()
        self.prof.stop()

    def reduce(self, top: int = 10,
               device_bounds: bool = False) -> Dict[str, object]:
        """With ``device_bounds`` the window shrinks to the device's
        first and last operation inside the span."""
        import torch

        cuda = torch.autograd.DeviceType.CUDA
        window = None
        device: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        for e in self.prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == cuda:
                if not (getattr(e, "is_user_annotation", False)
                        or e.name == WINDOW
                        or e.name.startswith("portbench.")):
                    device.append((a, b, e.name))
            elif e.name == WINDOW:
                window = (a, b)
            else:
                host.append((a, b, e.name))
        if window is None:
            raise RuntimeError("the trace has no window span")
        lo, hi = window
        inside = [(a, b) for a, b, _ in device if b > lo and a < hi]
        if device_bounds and inside:
            lo = max(lo, min(a for a, _ in inside))
            hi = min(hi, max(b for _, b in inside))
        by_name: Dict[str, List[float]] = collections.defaultdict(
            lambda: [0, 0.0])
        for a, b, n in device:
            if lo <= a < hi:
                by_name[n][0] += 1
                by_name[n][1] += (b - a) * 1e-6
        device = [(max(a, lo), min(b, hi), n) for a, b, n in device
                  if b > lo and a < hi]
        busy, gaps, cur = 0.0, [], lo
        for a, b, _ in sorted(device):
            if a > cur:
                gaps.append((cur, a))
            if b > cur:
                busy += b - max(a, cur)
                cur = b
        if hi > cur:
            gaps.append((cur, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        labelled = [[_label(host, (a + b) / 2), (b - a) * 1e-6]
                    for a, b in gaps[:top]]
        ops = sorted(([n, s] for n, (_, s) in by_name.items()),
                     key=lambda x: -x[1])
        return {
            "window_s": (hi - lo) * 1e-6,
            "busy_s": busy * 1e-6,
            "kernels": {n: {"count": c, "seconds": s}
                        for n, (c, s) in by_name.items()},
            "breakdown": {"device_ops": [[n[:160], s] for n, s in
                                         ops[:top]],
                          "idle_gaps": labelled},
        }


def _label(host, t: float) -> str:
    best = None
    for a, b, n in host:
        if a <= t <= b and (best is None or b - a < best[1] - best[0]):
            best = (a, b, n)
    return "host: no traced event" if best is None else best[2][:160]


def port_kernel_totals(kernels: Dict[str, Dict[str, float]],
                       key: str) -> Tuple[int, float]:
    """``(launches, seconds)`` of the port's kernel ``key`` (a
    :data:`PORT_KERNELS` key) in a reduced trace."""
    count, seconds = 0, 0.0
    for name, v in kernels.items():
        if PORT_KERNELS[key] in name:
            count += v["count"]
            seconds += v["seconds"]
    return count, seconds
