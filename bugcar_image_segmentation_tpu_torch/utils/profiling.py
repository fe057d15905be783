"""Observability: the port's spans and counters, the FPS meter and the
profiler trace.

Port of ``bugcar_image_segmentation_tpu/utils/profiling.py``, whose stage
timer the span recorder replaces: :class:`FPSMeter` gives the sustained
throughput over a sliding window, and :func:`trace` records a
``torch.profiler`` trace (CPU, and CUDA where a card is present) written
as a Chrome trace, where the JAX package wraps ``jax.profiler``.

**Spans and counters.**  The port's layers mark their own work where it
happens: ``with span("engine.segment_head"): ...`` around a stage, and
``count("engine_frames", k)`` / ``gauge("device_backlog", n)`` beside it.
:data:`RECORDER` keeps, in memory, each span as a :class:`Span`
``(name, start_ns, end_ns, parent, seq)`` (``parent`` is the index of the
enclosing span, ``seq`` the number of the outermost span of its tree, so
every span of one frame or dispatch shares it), each counter's sum and
each gauge's sum and count.  It holds at most :data:`CAPACITY` spans a
session and counts the rest in ``dropped``.  Spans nest by the order they
open and close: the pipeline runs on one thread (the capture threads of
``io/`` record nothing).

Recording is on while a ``torch.profiler`` is active and inside a
:func:`recording` block; outside both a site costs one check.  A session
opens when recording turns on (a profiler's start outside any
:func:`recording` block, or the outermost block's entry with no profiler
active), and the recorder keeps the latest session alone, so two traced
windows of one process never mix.  It learns of a profiler's start by
wrapping ``torch.autograd.profiler._run_on_profiler_start`` when this
module is imported.

Stamps are ``time.time_ns()``: the clock of the profiler's own events
(kineto's ``start_ns``; ``ts`` + ``baseTimeNanoseconds`` in its Chrome
trace), so a span brackets the profiler events recorded inside it.  Spans
are no ``record_function`` ranges: the profiler would mirror those onto
the device as annotations, counted there as the device's own work.  While
``torch.export`` or ``torch.compile`` trace, sites record nothing and
touch no tensor.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import os
import time
import warnings
from typing import Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

_profiler_enabled = torch._C._autograd._profiler_enabled
_compiling = torch.compiler.is_compiling

CAPACITY = 1 << 16          # spans a session; the rest count in ``dropped``
SPAN_TRACK = ("bugcar spans", "port")   # (pid, tid) of the spans in trace()


@dataclasses.dataclass(slots=True)
class Span:
    name: str
    start_ns: int
    end_ns: Optional[int]       # None while the span is open
    parent: Optional[int]       # index of the enclosing span, or None
    seq: int                    # number of the outermost span of its tree


class Recorder:
    """The spans, counters and gauges of the latest recording session."""

    def __init__(self):
        self.depth = 0              # open recording() blocks
        self._open: List[Optional[Tuple[int, Span]]] = []   # (index, span)
        self.reset()

    def reset(self) -> None:
        """Open a new, empty session."""
        self._spans: List[Span] = []
        self.counters: Dict[str, int] = {}
        self.gauges: Dict[str, List[float]] = {}
        self.dropped = 0
        self._roots = 0

    # -- recording -----------------------------------------------------------

    def _enter(self, name: str) -> None:
        spans, top = self._spans, self._open[-1] if self._open else None
        if len(spans) >= CAPACITY:
            self.dropped += 1
            self._open.append(None)
            return
        if (top is not None and top[0] < len(spans)
                and spans[top[0]] is top[1]):      # opened in this session
            s = Span(name, 0, None, top[0], top[1].seq)
        else:
            s = Span(name, 0, None, None, self._roots)
            self._roots += 1
        self._open.append((len(spans), s))
        spans.append(s)
        s.start_ns = time.time_ns()

    def _exit(self) -> None:
        end = time.time_ns()
        top = self._open.pop()
        if top is not None:
            top[1].end_ns = end

    def add(self, name: str, n) -> None:
        self.counters[name] = self.counters.get(name, 0) + int(n)

    def sample(self, name: str, value: float) -> None:
        g = self.gauges.setdefault(name, [0.0, 0])
        g[0] += float(value)
        g[1] += 1

    # -- reading -------------------------------------------------------------

    def spans(self) -> List[Span]:
        """The session's spans in the order they opened."""
        return list(self._spans)

    def total_ns(self, name: str) -> int:
        """Summed duration of the closed spans named ``name``."""
        return sum(s.end_ns - s.start_ns for s in self._spans
                   if s.name == name and s.end_ns is not None)

    def self_ns(self, name: str) -> int:
        """Summed self time of the closed spans named ``name``: each one's
        duration less the part of it that its child spans cover."""
        spans = self.spans()
        children: Dict[int, List[Tuple[int, int]]] = \
            collections.defaultdict(list)
        for s in spans:
            if s.parent is not None and s.end_ns is not None:
                children[s.parent].append((s.start_ns, s.end_ns))
        total = 0
        for i, s in enumerate(spans):
            if s.name != name or s.end_ns is None:
                continue
            covered, reach = 0, s.start_ns
            for a, b in sorted(children[i]):
                a, b = max(a, reach), min(b, s.end_ns)
                if b > a:
                    covered += b - a
                    reach = b
            total += s.end_ns - s.start_ns - covered
        return total

    def gauge_mean(self, name: str) -> Optional[float]:
        """Mean of the samples of gauge ``name``; None without one."""
        g = self.gauges.get(name)
        return g[0] / g[1] if g and g[1] else None


RECORDER = Recorder()


class _On:
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        RECORDER._enter(self.name)

    def __exit__(self, kind, value, tb) -> None:
        RECORDER._exit()


class _Off:
    __slots__ = ()

    def __enter__(self) -> None:
        pass

    def __exit__(self, kind, value, tb) -> None:
        pass


_OFF = _Off()


def active() -> bool:
    """Whether span, counter and gauge sites record now."""
    return bool(RECORDER.depth or _profiler_enabled()) and not _compiling()


def span(name: str):
    """A context manager that records the block as span ``name`` while
    recording is on, and does nothing otherwise."""
    # active()'s test written out: on an H100 host, calling active() here
    # made a site with recording off about 30 % dearer (0.39 against
    # 0.30 us, PERF.md §6), and a frame passes eight span sites
    if (RECORDER.depth or _profiler_enabled()) and not _compiling():
        return _On(name)
    return _OFF


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name`` while recording is on."""
    if active():
        RECORDER.add(name, n)


def gauge(name: str, value: float) -> None:
    """Add one sample of gauge ``name`` while recording is on."""
    if active():
        RECORDER.sample(name, value)


@contextlib.contextmanager
def recording() -> Iterator[Recorder]:
    """Record spans and counters in the block, without a profiler; the
    outermost block with no profiler active opens a new session."""
    if not RECORDER.depth and not _profiler_enabled():
        RECORDER.reset()
    RECORDER.depth += 1
    try:
        yield RECORDER
    finally:
        RECORDER.depth -= 1


def _on_profiler_start(start):
    """``start``, the profiler's start hook, then a new session unless a
    :func:`recording` block holds one."""
    def on_start():
        start()
        if not RECORDER.depth:
            RECORDER.reset()
    return on_start


if hasattr(_autograd_profiler, "_run_on_profiler_start"):   # torch >= 2.1
    _autograd_profiler._run_on_profiler_start = _on_profiler_start(
        _autograd_profiler._run_on_profiler_start)
else:
    warnings.warn("this torch has no profiler start hook: the span recorder "
                  "keeps every profiler window of the process in one session")


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


def _write_spans(path: str, spans: List[Span]) -> None:
    """Add ``spans`` to the Chrome trace at ``path`` as complete events on
    a track of their own, on the trace's clock."""
    with open(path) as f:
        doc = json.load(f)
    base = int(doc.get("baseTimeNanoseconds", 0))
    pid, tid = SPAN_TRACK
    events = doc.setdefault("traceEvents", [])
    events.append({"ph": "M", "name": "process_name", "pid": pid,
                   "tid": tid, "args": {"name": pid}})
    for s in spans:
        if s.end_ns is None:
            continue
        args = {"seq": s.seq}
        if s.parent is not None:
            args["parent"] = spans[s.parent].name
        events.append({"ph": "X", "cat": "span", "name": s.name, "pid": pid,
                       "tid": tid, "ts": (s.start_ns - base) / 1e3,
                       "dur": (s.end_ns - s.start_ns) / 1e3, "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """Profile the block with ``torch.profiler`` (CPU activity, and CUDA
    activity when a card is present) and write the Chrome trace
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing),
    the port's spans of the block on a track of their own beside the
    profiler's events; yields the profiler, whose ``key_averages()``
    summarise the block."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    _write_spans(path, RECORDER.spans())


__all__ = ["CAPACITY", "FPSMeter", "Recorder", "RECORDER", "Span", "active",
           "count", "gauge", "recording", "span", "trace"]
