"""The traced window: ``torch.profiler`` over CPU and CUDA, reduced to
what the per-layer readers read.

The window starts and ends with the device idle (a synchronise before
the profiler starts and before it stops), so every device operation in
it was launched in it.  Device operations are the profiler's CUDA events
(kernels, copies, sets), less the ranges the profiler mirrors onto the
device for the harness's spans.  A span's device time is the profiler's
``device_time_total`` of its CPU range: the kernels its calls launched,
linked by the profiler's correlation ids.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import torch

from .program import ENGINE_SPAN, GRID_SPAN
from .stats import gaps, union_length

SPANS = (ENGINE_SPAN, GRID_SPAN)
TOP = 10


class Summary:
    """What the readers see of a traced window."""

    def __init__(self):
        self.window_s = 0.0
        self.busy_s = 0.0
        self.frames = 0                       # frames the engine was handed
        self.calls = 0                        # engine calls that took them
        self.kernels: Dict[str, List[float]] = defaultdict(list)  # µs
        self.span_device_s: Dict[str, float] = {s: 0.0 for s in SPANS}
        self.device_ops: List[Tuple[str, float]] = []
        self.idle_gaps: List[Tuple[str, float]] = []
        self.unlinked_kernel_s = 0.0

    @property
    def kernel_launches(self) -> int:
        return sum(len(v) for v in self.kernels.values())

    def matching(self, key: str) -> List[float]:
        """µs of every kernel launch whose name contains ``key``."""
        return [d for name, ds in self.kernels.items() if key in name
                for d in ds]


class Window:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.prof = None
        self.t0 = 0.0
        self.summary: Optional[Summary] = None

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def start(self) -> None:
        self._sync()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.t0 = time.perf_counter()

    def stop(self, frames: int, calls: int) -> Summary:
        self._sync()
        window_s = time.perf_counter() - self.t0
        self.prof.stop()
        self.summary = summarise(self.prof.events(), window_s, frames)
        self.summary.calls = calls
        self.prof = None
        return self.summary


def _is_device(e) -> bool:
    return e.device_type == torch.autograd.DeviceType.CUDA


def summarise(events, window_s: float, frames: int) -> Summary:
    s = Summary()
    s.window_s, s.frames = window_s, frames
    device, host = [], []
    for e in events:
        if _is_device(e):
            if e.name not in SPANS:
                device.append(e)
        else:
            host.append(e)
            if e.name in s.span_device_s:
                s.span_device_s[e.name] += e.device_time_total / 1e6
    spans = [(e.time_range.start, e.time_range.end) for e in device]
    s.busy_s = union_length(spans) / 1e6
    by_name: Dict[str, float] = defaultdict(float)
    for e in device:
        d = e.time_range.elapsed_us()
        by_name[e.name] += d
        if not e.name.startswith(("Memcpy", "Memset")):
            s.kernels[e.name].append(d)
    s.device_ops = sorted(((n, v / 1e6) for n, v in by_name.items()),
                          key=lambda kv: -kv[1])[:TOP]
    linked = sum(s.span_device_s.values())
    s.unlinked_kernel_s = max(
        sum(sum(v) for v in s.kernels.values()) / 1e6 - linked, 0.0)
    s.idle_gaps = _idle_gaps(spans, host)
    return s


def _idle_gaps(spans, host) -> List[Tuple[str, float]]:
    """Every idle stretch of the device between its first and last
    operation, summed by the innermost host operation running at the
    stretch's middle (a sweep over the host ranges sorted by start)."""
    if not spans or not host:
        return []
    lo = min(a for a, _ in spans)
    hi = max(b for _, b in spans)
    idle = sorted(((a + b) / 2, b - a) for a, b in gaps(spans, lo, hi))
    ranges = sorted((e.time_range.start, e.time_range.end, e.name)
                    for e in host)
    totals: Dict[str, float] = defaultdict(float)
    stack: List[Tuple[float, float, str]] = []
    i = 0
    for mid, length in idle:
        while i < len(ranges) and ranges[i][0] <= mid:
            stack.append(ranges[i])
            i += 1
        while stack and stack[-1][1] < mid:
            stack.pop()
        name = stack[-1][2] if stack else "(Python between host operations)"
        totals[name] += length / 1e6
    return sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
