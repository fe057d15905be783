"""Observability: per-stage latency and FPS metering, and the profiler
trace.

Port of ``bugcar_image_segmentation_tpu/utils/profiling.py``.
:class:`StageTimer` collects per-stage wall-clock percentiles,
:class:`FPSMeter` the sustained throughput over a sliding window, and
:func:`trace` records a ``torch.profiler`` trace (CPU, and CUDA where a
card is present) written as a Chrome trace, where the JAX package wraps
``jax.profiler``.
"""

from __future__ import annotations

import collections
import contextlib
import os
import time
from typing import Dict, Iterator

import numpy as np
import torch


class StageTimer:
    """Wall-clock percentile tracker for named pipeline stages."""

    def __init__(self, window: int = 512):
        self._samples: Dict[str, collections.deque] = \
            collections.defaultdict(lambda: collections.deque(maxlen=window))

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, samples in self._samples.items():
            arr = np.asarray(samples)
            if arr.size == 0:
                continue
            out[name] = {
                "n": int(arr.size),
                "mean_ms": float(arr.mean() * 1e3),
                "p50_ms": float(np.percentile(arr, 50) * 1e3),
                "p95_ms": float(np.percentile(arr, 95) * 1e3),
                "p99_ms": float(np.percentile(arr, 99) * 1e3),
            }
        return out


class FPSMeter:
    """Sustained-throughput meter over a sliding frame window."""

    def __init__(self, window: int = 120):
        self._stamps: collections.deque = collections.deque(maxlen=window)

    def tick(self) -> None:
        self._stamps.append(time.perf_counter())

    @property
    def fps(self) -> float:
        if len(self._stamps) < 2:
            return 0.0
        span = self._stamps[-1] - self._stamps[0]
        return (len(self._stamps) - 1) / span if span > 0 else 0.0


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write the Chrome trace
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing);
    yields the profiler, whose ``key_averages()`` summarise the block."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


__all__ = ["StageTimer", "FPSMeter", "trace"]
