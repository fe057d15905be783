"""The reader of ``engine_graph_share``: 100 x the port's
``engine_graph_frames`` over ``engine_frames``, and nothing without a
traced window, with dropped spans, without frames, or on a port whose
engine replays no graph."""

import types

import pytest

from perfbench import manifest

TRACED = types.SimpleNamespace(trace=object())


@pytest.fixture
def read():
    from bugcar_image_segmentation_tpu_torch.utils.profiling import \
        recording
    reader = manifest.reader("engine_graph_share.live")

    def run(counters, ctx=TRACED, dropped=0):
        with recording() as rec:
            rec.counters.update(counters)
            rec.dropped = dropped
        return reader.read(ctx, "engine_graph_share.live")
    return run


@pytest.mark.parametrize("graph,frames,want", [(0, 8, 0.0), (6, 8, 75.0),
                                               (8, 8, 100.0)])
def test_the_share_of_replayed_frames(read, graph, frames, want):
    counters = {"engine_frames": frames}
    if graph:
        counters["engine_graph_frames"] = graph
    assert read(counters) == pytest.approx(want)


def test_nothing_to_read(read):
    counters = {"engine_frames": 8, "engine_graph_frames": 8}
    assert read(counters, ctx=types.SimpleNamespace(trace=None)) is None
    assert read(counters, dropped=1) is None
    assert read({"engine_graph_frames": 8}) is None


def test_a_port_that_replays_no_graph(read, monkeypatch):
    from bugcar_image_segmentation_tpu_torch.models import api
    monkeypatch.delattr(api, "replays")
    assert read({"engine_frames": 8}) is None
