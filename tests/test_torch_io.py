"""The port's frame IO (``io/``) against the JAX package's: the native
frame ring (the port's byte-identical copy of ``frame_ring.cpp``, built
into ``build/native/``), the synthetic source, the capture thread, the
stall watchdog and the drop counter; and ``utils.profiling`` (the FPS
meter, the profiler's Chrome trace).

Each ring case of ``tests/test_io_training.py`` runs on both rings with the
same push / pop sequence and must give the same frames, sequence numbers
and drop counts, and the JAX test's own expectations.
"""

import threading
import time
from pathlib import Path

import numpy as np
import pytest

from bugcar_image_segmentation_tpu import io as jio
from bugcar_image_segmentation_tpu_torch import io as tio
from bugcar_image_segmentation_tpu_torch.io import ring as tring

REPO = Path(__file__).resolve().parents[1]
SHAPE = (16, 24, 3)
RINGS = {"jax": jio.FrameRing, "port": tio.FrameRing}


def _pop(out):
    """A pop's result as comparable values: None, or (bytes, number)."""
    return None if out is None else (out[0].tobytes(), out[1])


def case_roundtrip(Ring):
    ring = Ring(SHAPE, capacity=4)
    frame = np.arange(np.prod(SHAPE), dtype=np.uint8).reshape(SHAPE)
    seq = ring.push(frame)
    out = ring.pop_next(timeout_ms=100)
    assert seq == 0 and out[1] == 0
    np.testing.assert_array_equal(out[0], frame)
    return [seq, _pop(out)]


def case_latest_drops(Ring):
    ring = Ring(SHAPE, capacity=8)
    seqs = [ring.push(np.full(SHAPE, i, np.uint8)) for i in range(5)]
    out = ring.pop_latest(timeout_ms=100)
    assert out[0][0, 0, 0] == 4 and out[1] == 4 and ring.pending == 0
    return [seqs, _pop(out), ring.pending]


def case_overwrite_oldest(Ring):
    ring = Ring(SHAPE, capacity=2)
    seqs = [ring.push(np.full(SHAPE, i, np.uint8)) for i in range(5)]
    out = ring.pop_next(timeout_ms=100)
    # capacity 2: frames 0-2 were overwritten; the oldest left is 3
    assert out[1] == 3 and out[0][0, 0, 0] == 3
    return [seqs, _pop(out), _pop(ring.pop_next(timeout_ms=10)),
            _pop(ring.pop_next(timeout_ms=10))]


def case_timeout(Ring):
    ring = Ring(SHAPE, capacity=2)
    t0 = time.perf_counter()
    out = ring.pop_latest(timeout_ms=50)
    assert out is None and time.perf_counter() - t0 >= 0.045
    return [out]


def case_concurrent_producer(Ring):
    # capacity >= frame count: nothing overwritten, all arrive in order
    ring = Ring(SHAPE, capacity=64)

    def produce():
        for i in range(50):
            ring.push(np.full(SHAPE, i % 256, np.uint8))

    t = threading.Thread(target=produce)
    t.start()
    got = []
    while len(got) < 50:
        out = ring.pop_next(timeout_ms=500)
        if out is None:
            break
        assert out[0][0, 0, 0] == out[1] % 256
        got.append(_pop(out))
    t.join()
    assert [s for _, s in got] == list(range(50))
    return got


def case_close_drains(Ring):
    ring = Ring(SHAPE, capacity=4)
    for i in range(3):
        ring.push(np.full(SHAPE, 10 + i, np.uint8))
    ring.close()
    return [_pop(ring.pop_next(timeout_ms=50)) for _ in range(4)]


def case_shape_mismatch(Ring):
    ring = Ring(SHAPE, capacity=2)
    with pytest.raises(ValueError, match="frame shape"):
        ring.push(np.zeros((8, 8, 3), np.uint8))
    return [ring.pending]


CASES = [case_roundtrip, case_latest_drops, case_overwrite_oldest,
         case_timeout, case_concurrent_producer, case_close_drains,
         case_shape_mismatch]


@pytest.mark.parametrize("case", CASES, ids=lambda c: c.__name__[5:])
def test_ring_equals_jax(case):
    assert case(RINGS["port"]) == case(RINGS["jax"])


def test_ring_source_is_the_jax_copy():
    ours = REPO / "bugcar_image_segmentation_tpu_torch/io/native/frame_ring.cpp"
    theirs = REPO / "bugcar_image_segmentation_tpu/io/native/frame_ring.cpp"
    assert ours.read_bytes() == theirs.read_bytes()


def test_ring_builds_under_build_dir():
    path = tring.build()
    assert path.parent == REPO / "build" / "native"
    assert path == tring.library_path() and path.exists()
    assert path.name.startswith("libframe_ring-")
    # nothing is written beside the source (and its TSAN harness)
    assert sorted(p.name for p in tring.SOURCE.parent.iterdir()) == \
        ["frame_ring.cpp", "frame_ring_test.cpp"]


@pytest.mark.parametrize("shape,n", [((8, 8, 3), 3), ((480, 640, 3), 4),
                                     ((5, 1, 3), 40)])
def test_synthetic_source_equals_jax(shape, n):
    ours = list(tio.SyntheticSource(shape, num_frames=n))
    theirs = list(jio.SyntheticSource(shape, num_frames=n))
    assert len(ours) == len(theirs) == n
    for a, b in zip(ours, theirs):
        assert a.dtype == b.dtype == np.uint8
        np.testing.assert_array_equal(a, b)


def test_threaded_capture_live_drains():
    src = tio.SyntheticSource(SHAPE, num_frames=20)
    cap = tio.ThreadedCapture(src, SHAPE, capacity=4).start()
    seen = dropped = 0
    while True:
        out = cap.latest(timeout_ms=500)
        if out is None:
            break
        seen += 1
        dropped += out[1]
    cap.stop()
    assert 1 <= seen <= 20 and seen + dropped <= 20
    assert cap.frames_pushed == 20


def test_threaded_capture_offline_is_lossless():
    """``block_when_full`` + ``next``: every frame, in order, the JAX
    source's bytes, with a ring far smaller than the stream."""
    cap = tio.ThreadedCapture(tio.SyntheticSource(SHAPE, num_frames=40),
                              SHAPE, capacity=4,
                              block_when_full=True).start()
    got = []
    while True:
        out = cap.next(timeout_ms=500)
        if out is None:
            break
        got.append(out)
        time.sleep(0.001)      # a consumer slower than the producer
    cap.stop()
    want = list(jio.SyntheticSource(SHAPE, num_frames=40))
    assert [s for _, s in got] == list(range(40))
    for (frame, _), ref in zip(got, want):
        np.testing.assert_array_equal(frame, ref)


def test_watchdog_detects_stall_and_recovers():
    events = []
    wd = tio.StallWatchdog(stall_after_s=0.2, poll_s=0.05,
                           on_stall=lambda age: events.append(age)).start()
    try:
        for _ in range(6):
            wd.tick()
            time.sleep(0.05)
        assert wd.stall_count == 0 and not wd.stalled
        time.sleep(0.5)
        assert wd.stall_count == 1 and wd.stalled
        assert events and events[0] >= 0.2
        wd.tick()
        time.sleep(0.1)
        assert not wd.stalled
        time.sleep(0.5)
        assert wd.stall_count == 2
    finally:
        wd.stop()


def test_watchdog_stop_idempotent():
    wd = tio.StallWatchdog(stall_after_s=10).start()
    wd.stop()
    wd.stop()


@pytest.mark.parametrize("drops", [[], [0, 3], [2, 0, 0, -1, 5]])
def test_drop_counter_equals_jax(drops):
    ours, theirs = tio.DropCounter(), jio.DropCounter()
    for d in drops:
        ours.record(d)
        theirs.record(d)
    assert (ours.frames, ours.dropped, ours.drop_rate) == \
        (theirs.frames, theirs.dropped, theirs.drop_rate)
    if drops == [0, 3]:
        assert abs(ours.drop_rate - 3 / 5) < 1e-9


def test_fps_meter_rates_its_window():
    """``utils.profiling.FPSMeter`` gives the tick rate over its window
    (the span recorder is held in tests/test_torch_tracing.py)."""
    from bugcar_image_segmentation_tpu_torch.utils import profiling as tprof
    meter = tprof.FPSMeter(window=4)
    assert meter.fps == 0.0
    for _ in range(6):
        meter.tick()
        time.sleep(0.002)
    assert 0 < meter.fps < 1000


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    import torch

    from bugcar_image_segmentation_tpu_torch.utils import get_logger, trace
    with trace(str(tmp_path)) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    events = json.loads((tmp_path / "trace.json").read_text())
    assert events["traceEvents"]
    assert any("mm" in e.key for e in prof.key_averages())
    log = get_logger("io_test")
    assert log is get_logger("io_test") and len(log.handlers) == 1
