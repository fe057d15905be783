"""The engine's CUDA-graph replay (``models/api.py``) as far as a CPU can
hold it: which calls replay (the rule reads only what the call can
observe), what keys a captured program, that weights swapped in drop the
graphs, that the device caches hand a capture what it reads, that the
launch counts a replay adds are the capture's, and that a CPU engine
counts no replayed frame and records the spans it recorded before.

The capture and replay themselves need a card: ``tests/test_torch_cuda.py``
holds replay bit-equal to eager there.  CPU only, one torch thread, a tiny
seeded ENet.
"""

import copy
import types

import numpy as np
import pytest
import torch

import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.models import preprocess, remap
from bugcar_image_segmentation_tpu_torch.models.api import graph_key, replays
from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
from bugcar_image_segmentation_tpu_torch.ops import held_cache
from bugcar_image_segmentation_tpu_torch.utils.profiling import (RECORDER,
                                                                 recording)

MODEL = dict(input_width=64, input_height=32, dtype="float32")
CUDA = torch.device("cuda")
ENGINE_SPANS = ["engine.segment_head", "engine.preprocess",
                "engine.backbone", "engine.remap"]


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def engine():
    return port.build_engine("enet", port.ModelConfig(**MODEL), device="cpu",
                             seed=3)


@pytest.fixture
def frames():
    rng = np.random.default_rng(5)
    return torch.as_tensor(rng.integers(0, 256, (2, 32, 64, 3), np.uint8))


def _stand_in():
    """What replays reads of an engine, nothing sharded."""
    return types.SimpleNamespace(spatial=None, placer=None)


def test_a_plain_cuda_call_replays():
    assert replays(_stand_in(), CUDA)


@pytest.mark.parametrize("case", ["cpu", "spatial", "placer", "exporting",
                                  "compiling"])
def test_the_calls_that_run_eagerly(case, monkeypatch):
    eng, device = _stand_in(), CUDA
    if case == "cpu":
        device = torch.device("cpu")
    elif case == "spatial":
        eng.spatial = object()
    elif case == "placer":
        eng.placer = lambda e: None
    elif case == "exporting":
        monkeypatch.setattr(torch.compiler, "is_exporting", lambda: True)
    else:
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    assert not replays(eng, device)


def test_exporting_an_engine_asks_the_rule_from_inside_the_trace(
        engine, monkeypatch):
    seen = []

    def rule(eng, device):
        seen.append(torch.compiler.is_exporting())
        return False

    monkeypatch.setattr("bugcar_image_segmentation_tpu_torch.models.api."
                        "replays", rule)

    class Head(torch.nn.Module):
        def forward(self, x):
            return engine.segment_head(x)

    x = torch.zeros((1, 32, 64, 3), dtype=torch.uint8)
    torch.export.export(Head(), (x,))
    assert seen and all(seen)


def test_the_key(engine, frames):
    key = graph_key(engine, frames, "multiclass")
    assert key == graph_key(engine, frames.clone(), "multiclass")
    assert key != graph_key(engine, frames[:1], "multiclass")
    assert key != graph_key(engine, frames.float(), "multiclass")
    assert key != graph_key(engine, frames, "binary")
    engine.module.xla_attention = True
    try:
        assert key != graph_key(engine, frames, "multiclass")
    finally:
        del engine.module.xla_attention
    engine.module.train()
    try:
        assert key != graph_key(engine, frames, "multiclass")
    finally:
        engine.module.eval()
    assert key == graph_key(engine, frames, "multiclass")


@pytest.mark.parametrize("mode", ["multiclass", "binary"])
def test_a_cpu_engine_counts_no_replayed_frame(engine, frames, mode):
    with recording():
        engine.segment_head(frames, mode)
        engine.segment_head(frames[:1], mode)
        engine.segment_head(frames, mode)
    assert RECORDER.counters == {"engine_frames": 5}
    assert "engine_graph_frames" not in RECORDER.counters
    assert engine.graphs == {}


def test_the_spans_of_a_cpu_engine_are_unchanged(engine, frames):
    with recording():
        engine.segment_head(frames)
    spans = RECORDER.spans()
    assert [s.name for s in spans] == ENGINE_SPANS
    assert [s.parent for s in spans] == [None, 0, 0, 0]


def test_load_variables_drops_the_graphs(frames):
    eng = port.build_engine("enet", port.ModelConfig(**MODEL), device="cpu",
                            seed=3)
    eng.graphs[graph_key(eng, frames, "multiclass")] = None
    eng.load_variables(None)
    assert eng.graphs == {}


class _Uncopyable:
    """Stands in for a captured graph, which cannot be copied."""

    def __reduce_ex__(self, protocol):
        raise TypeError("cannot pickle 'CUDAGraph' object")


def test_a_copy_of_an_engine_has_no_graphs(frames):
    eng = port.build_engine("enet", port.ModelConfig(**MODEL), device="cpu",
                            seed=3)
    key = graph_key(eng, frames, "multiclass")
    eng.graphs[key] = _Uncopyable()
    snap = copy.deepcopy(eng)
    assert snap.graphs == {} and key in eng.graphs
    assert snap.module is not eng.module
    assert torch.equal(snap.segment_head(frames), eng._head(frames,
                                                           "multiclass"))


def test_a_held_block_keeps_what_the_device_caches_returned():
    cpu = torch.device("cpu")
    with held_cache() as held:
        const = preprocess._const((1.0, 2.0, 3.0), cpu)
        lut = remap._lut(tuple(range(15)), cpu)
        with held_cache() as inner:
            again = preprocess._const((1.0, 2.0, 3.0), cpu)
        assert inner == [again] and again is const
    assert held == [const, lut]
    with held_cache() as later:
        pass
    preprocess._const((1.0, 2.0, 3.0), cpu)
    assert later == []


def test_a_replay_adds_the_launches_its_capture_counted():
    saved = kcuda.launch_counts()
    try:
        kcuda.reset_launches()
        before = kcuda.launch_counts()
        kcuda.LAUNCHES["flash_attention"] += 2
        kcuda.LAUNCHES["flash_attention_t"] += 6
        kcuda.ROUTES["halo_add"]["tma"] += 1
        after = kcuda.launch_counts()
        delta = {k: n - before[k] for k, n in after.items()
                 if n != before[k]}
        assert delta == {("flash_attention",): 2, ("flash_attention_t",): 6,
                         ("halo_add", "tma"): 1}
        kcuda.add_launches(delta)
        assert kcuda.LAUNCHES["flash_attention"] == 4
        assert kcuda.LAUNCHES["flash_attention_t"] == 12
        assert kcuda.ROUTES["halo_add"] == {"tma": 2, "simt": 0}
    finally:
        kcuda.reset_launches()
        kcuda.add_launches({k: n for k, n in saved.items() if n})
