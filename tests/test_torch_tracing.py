"""The port's spans and counters (``utils/profiling.py``): where the
pipeline, the engine and the grid builder record them, when recording is
on, how sessions are kept apart, that the spans share the profiler's
clock, and that exporting a pipeline records nothing.

CPU only: a tiny ENet pipeline on seeded weights.
"""

import json

import numpy as np
import pytest
import torch

import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import deploy
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.utils import profiling
from bugcar_image_segmentation_tpu_torch.utils.profiling import (RECORDER,
                                                                 recording)

MODEL = dict(input_width=64, input_height=32, dtype="float32")
GRID = (4.0, 4.0, 0.2)
CAMERA = (48, 96, 3)
# span → its parent, in one frame through Pipeline.__call__
FRAME_TREE = {"pipeline.frame": None,
              "pipeline.upload": "pipeline.frame",
              "pipeline.program": "pipeline.frame",
              "engine.segment_head": "pipeline.program",
              "engine.preprocess": "engine.segment_head",
              "engine.backbone": "engine.segment_head",
              "engine.remap": "engine.segment_head",
              "grid.build": "pipeline.program"}


@pytest.fixture(scope="module")
def engine():
    return port.build_engine("enet", port.ModelConfig(**MODEL), device="cpu",
                             seed=3)


@pytest.fixture(scope="module")
def frames():
    rng = np.random.default_rng(5)
    return [rng.integers(0, 256, CAMERA, np.uint8) for _ in range(7)]


def _pipe(engine, **kw):
    return port.Pipeline(engine, toy_calibration((32, 64)),
                         port.GridConfig(*GRID), **kw)


@pytest.fixture
def pipe(engine):
    return _pipe(engine)


def _empty_session():
    with recording():
        pass
    assert RECORDER.spans() == [] and RECORDER.counters == {}


@pytest.fixture
def profiled():
    """A block under ``torch.profiler`` (CPU); yields the profiler."""
    def run(fn):
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            fn()
        return prof
    return run


def _session(how, fn, profiled):
    if how == "profiler":
        profiled(fn)
    else:
        with recording():
            fn()
    return RECORDER.spans()


def _tree(spans):
    return [(s.name, None if s.parent is None else spans[s.parent].name)
            for s in spans]


def test_nothing_is_recorded_outside_a_session(pipe, frames):
    _empty_session()
    pipe(frames[0])
    list(pipe.stream(iter(frames[:5]), depth=2, sync_chunk=2,
                     transfer_batch=2))
    pipe.run_batch(np.stack(frames[:3]))
    assert RECORDER.spans() == [] and RECORDER.counters == {}
    assert RECORDER.gauges == {} and not profiling.active()


@pytest.mark.parametrize("how", ["profiler", "recording"])
def test_a_frame_records_the_tree_of_spans(pipe, frames, how, profiled):
    spans = _session(how, lambda: pipe(frames[0]), profiled)
    assert sorted(_tree(spans)) == sorted(FRAME_TREE.items())
    assert {s.seq for s in spans} == {0}
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns <= s.end_ns <= p.end_ns
    assert RECORDER.counters == {"engine_frames": 1}
    assert RECORDER.dropped == 0


def test_a_frame_by_frame_backbone_records_a_span_a_frame(engine, frames):
    pipe = _pipe(engine)
    engine.frame_by_frame = True
    try:
        with recording():
            pipe.run_batch(np.stack(frames[:3]))
    finally:
        engine.frame_by_frame = False
    spans = RECORDER.spans()
    (head,) = [i for i, s in enumerate(spans)
               if s.name == "engine.segment_head"]
    backbone = [s for s in spans if s.name == "engine.backbone"]
    assert len(backbone) == 3 and all(s.parent == head for s in backbone)
    assert RECORDER.counters["engine_frames"] == 3


@pytest.mark.parametrize("transport", ["bgr", "i420"])
@pytest.mark.parametrize("transfer_batch", [1, 3])
def test_stream_records_dispatches_drains_and_counts(engine, frames,
                                                     transfer_batch,
                                                     transport):
    kw = (dict(host_resize=True, transport="i420") if transport == "i420"
          else {})
    pipe = _pipe(engine, **kw)
    with recording():
        out = list(pipe.stream(iter(frames), depth=2, sync_chunk=2,
                               transfer_batch=transfer_batch))
    spans = RECORDER.spans()
    dispatches = -(-len(frames) // transfer_batch)
    uploaded = dispatches * transfer_batch     # the last batch is padded
    names = [s.name for s in spans]
    assert names.count("pipeline.dispatch") == dispatches
    assert names.count("pipeline.upload") == dispatches
    assert names.count("pipeline.drain") >= 1
    roots = [s for s in spans if s.parent is None]
    assert {s.name for s in roots} == {"pipeline.dispatch", "pipeline.drain"}
    assert [s.seq for s in roots] == list(range(len(roots)))
    for s in spans:
        root = s
        while root.parent is not None:
            root = spans[root.parent]
        assert s.seq == root.seq
    inner = "pipeline.frame" if transfer_batch == 1 else "pipeline.program"
    assert all(spans[s.parent].name == "pipeline.dispatch"
               for s in spans if s.name == inner)
    assert RECORDER.counters == {"engine_frames": uploaded,
                                 "grids_out": len(out)}
    assert len(out) == len(frames)
    assert RECORDER.gauges == {}          # device_backlog needs a card


def test_the_buffer_bound_counts_what_it_drops(pipe, frames, monkeypatch):
    monkeypatch.setattr(profiling, "CAPACITY", 5)
    with recording():
        pipe(frames[0])
        pipe(frames[1])
    spans = RECORDER.spans()
    assert len(spans) == 5
    assert RECORDER.dropped == 2 * len(FRAME_TREE) - 5
    assert all(s.parent is None or s.parent < i for i, s in enumerate(spans))
    assert RECORDER.counters["engine_frames"] == 2   # counters still count


def test_a_profiler_start_opens_a_session():
    """The recorder learns of a profiler's start through torch's start
    hook, which it wraps when the module is imported."""
    import torch.autograd.profiler as autograd_profiler
    hook = autograd_profiler._run_on_profiler_start
    assert hook.__qualname__ == "_on_profiler_start.<locals>.on_start"
    with recording():
        profiling.count("n")
    hook()
    assert RECORDER.counters == {}


@pytest.mark.parametrize("first,second", [("profiler", "profiler"),
                                          ("recording", "profiler"),
                                          ("profiler", "recording")])
def test_two_sessions_do_not_mix(pipe, frames, first, second, profiled):
    _session(first, lambda: [pipe(f) for f in frames[:3]], profiled)
    assert RECORDER.counters["engine_frames"] == 3
    spans = _session(second, lambda: pipe(frames[0]), profiled)
    assert sorted(_tree(spans)) == sorted(FRAME_TREE.items())
    assert {s.seq for s in spans} == {0}
    assert RECORDER.counters["engine_frames"] == 1


def test_a_recording_block_inside_a_profiler_keeps_its_session(pipe,
                                                               frames,
                                                               profiled):
    def run():
        pipe(frames[0])
        with recording():
            pipe(frames[1])
    profiled(run)
    assert RECORDER.counters["engine_frames"] == 2
    assert [s.seq for s in RECORDER.spans()
            if s.name == "pipeline.frame"] == [0, 1]


def test_spans_bracket_the_profilers_events(pipe, frames, profiled):
    """The spans' stamps are on the profiler's clock: its events of the
    call lie inside ``pipeline.frame``, and its convolutions inside
    ``engine.backbone``."""
    prof = profiled(lambda: pipe(frames[0]))
    spans = RECORDER.spans()
    (frame,) = [s for s in spans if s.name == "pipeline.frame"]
    (backbone,) = [s for s in spans if s.name == "engine.backbone"]
    (grid,) = [s for s in spans if s.name == "grid.build"]
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name().startswith("aten::")]
    assert events
    for e in events:
        assert frame.start_ns <= e.start_ns() <= e.end_ns() <= frame.end_ns
    convs = [e for e in events if e.name() == "aten::conv2d"]
    assert convs
    for e in convs:
        assert (backbone.start_ns <= e.start_ns() <= e.end_ns()
                <= backbone.end_ns)
        assert not grid.start_ns <= e.start_ns() <= grid.end_ns


def test_self_time_is_the_span_less_its_children():
    import time
    with recording():
        with profiling.span("outer"):
            time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.002)
            with profiling.span("inner"):
                time.sleep(0.001)
        profiling.count("n", 2)
        profiling.gauge("g", 1)
        profiling.gauge("g", 4)
    outer, a, b = RECORDER.spans()
    dur = [s.end_ns - s.start_ns for s in (outer, a, b)]
    assert RECORDER.self_ns("outer") == dur[0] - dur[1] - dur[2]
    assert RECORDER.total_ns("inner") == dur[1] + dur[2]
    assert RECORDER.self_ns("inner") == dur[1] + dur[2]
    assert (a.parent, b.parent, a.seq) == (0, 0, 0)
    assert RECORDER.counters == {"n": 2}
    assert RECORDER.gauge_mean("g") == 2.5
    assert RECORDER.gauge_mean("absent") is None


def test_export_pipeline_with_recording_on(pipe, frames):
    frame = np.ascontiguousarray(frames[0][:32, :64])
    with recording():
        exported = deploy.export_pipeline(pipe)
        assert RECORDER.spans() == [] and RECORDER.counters == {}
        grid, seg = exported.module()(torch.as_tensor(frame))
    want_grid, want_seg = pipe.segment_and_grid(frame)
    np.testing.assert_array_equal(grid.numpy(), want_grid.numpy())
    np.testing.assert_array_equal(seg.numpy(), want_seg.numpy())


def test_trace_puts_the_spans_on_the_profilers_timeline(pipe, frames,
                                                        tmp_path):
    """In ``trace()``'s Chrome trace the engine's aten operations lie
    inside the ``engine.segment_head`` span, on a track of its own."""
    with profiling.trace(str(tmp_path)):
        pipe(frames[0])
    doc = json.loads((tmp_path / "trace.json").read_text())
    events = doc["traceEvents"]
    ours = [e for e in events if e.get("pid") == profiling.SPAN_TRACK[0]
            and e.get("ph") == "X"]
    assert sorted(e["name"] for e in ours) == sorted(FRAME_TREE)
    (head,) = [e for e in ours if e["name"] == "engine.segment_head"]
    convs = [e for e in events if e.get("name") == "aten::conv2d"
             and e.get("ph") == "X"]
    assert convs
    for e in convs:
        assert head["ts"] <= e["ts"] <= e["ts"] + e["dur"] <= (
            head["ts"] + head["dur"])
