"""The Xception-65 DeepLabV3+ cell: the separable-conv kernel's counts
against the reference's products, its readers, and a tiny cell run end
to end on the CPU.

The tiny root is built here from the real manifest's Xception entries
(``data/tiny_xception.json``: 2 middle blocks, 64x128), with the cell's
own limits."""

import json
import shutil
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from bugcar_image_segmentation_tpu_torch import grid as port_grid
from bugcar_image_segmentation_tpu_torch import pipeline as port_pipeline
from bugcar_image_segmentation_tpu_torch.models import xception as port_x
from perfbench import manifest, peaks, readings, roofline, run
from perfbench.reference import xception
from perfbench.reference.common import Precision
from perfbench.tests.conftest import BENCH, HERE, REPO

CONFIG = "xception65_deeplabv3plus_1024x512"
CELL = f"{CONFIG}.stream"
TINY = "tiny_xception"
FULL = json.loads((BENCH / "configs" / f"{CONFIG}.json").read_text())
SMALL = json.loads((HERE / "data" / f"{TINY}.json").read_text())


def _tiny_root(tmp: Path) -> Path:
    bench = tmp / "perfbench"
    for sub in ("metrics", "costs", "traffic"):
        shutil.copytree(BENCH / sub, bench / sub)
    (bench / "configs").mkdir()
    shutil.copy(HERE / "data" / f"{TINY}.json", bench / "configs")
    (bench / "limits").mkdir()
    shutil.copy(BENCH / "limits" / f"{CELL}.json",
                bench / "limits" / f"{TINY}.stream.json")
    text = (REPO / "BENCHMARK.json").read_text().replace(CONFIG, TINY)
    (tmp / "BENCHMARK.json").write_text(text)
    return tmp


def test_the_kernel_serves_55_sites_at_the_published_widths():
    cost = manifest.cost("fused_sepconv")
    sites = cost.sites(FULL)
    assert len(sites) == 55 and len(cost.launches(FULL, 4)) == 55
    assert sites[:7] == [(256, 512, 64, 128, 1), (256, 512, 128, 128, 1),
                         (256, 512, 128, 128, 2), (128, 256, 128, 256, 1),
                         (128, 256, 256, 256, 1), (64, 128, 256, 728, 1),
                         (64, 128, 728, 728, 1)]
    assert sites[7:] == [(32, 64, 728, 728, 1)] * 48
    # one launch takes the whole batch: its work grows with it
    one, four = cost.launches(FULL, 1), cost.launches(FULL, 4)
    assert all(f4 == 4 * f1 for (f1, _), (f4, _) in zip(one, four))
    least = sum(peaks.least_seconds(f, b) for f, b in one)
    assert 0.18e-3 < least < 0.19e-3          # PERF.md's bound a frame


def test_the_kernels_flops_are_the_references_kernel_sites(monkeypatch):
    """Σ FLOPs of the counted launches = the products of the reference's
    separable convs that the kernel serves, counted on shapes alone."""
    counted = []
    plain = xception.Model._sep

    def sep(self, key, x, stride, dilation, act_out):
        with FlopCounterMode(display=False) as counter:
            y = plain(self, key, x, stride, dilation, act_out)
        if dilation == 1 and (stride == 1 or x.shape[1] == 128):
            counted.append(float(counter.get_total_flops()))
        return y

    monkeypatch.setattr(xception.Model, "_sep", sep)
    w = {k: torch.empty(s, device="meta") for k, s in xception.layout(SMALL)}
    x = torch.empty((2, SMALL["input_height"], SMALL["input_width"], 3),
                    device="meta")
    xception.Model(w, SMALL, Precision())(x)
    got = [f for f, _ in manifest.cost("fused_sepconv").launches(SMALL, 2)]
    assert got == counted and len(got) == 7 + 3 * 2


def test_the_roofline_share_of_batched_launches():
    per_call = manifest.cost("fused_sepconv").launches(SMALL, 4)

    class Trace:
        frames, calls = 12, 3

        def matching(self, key):
            assert key == "sepconv_bf16"
            return [50.0] * 3 * len(per_call)

    class Ctx:
        trace, cfg, base, notes = Trace(), SMALL, BENCH, {}

    least = sum(peaks.least_seconds(f, b) for f, b in per_call)
    got = roofline.share(Ctx, "fused_sepconv")
    assert abs(got - 100.0 * least / (len(per_call) * 50e-6)) < 1e-9


def test_launches_per_grid_reads_the_ports_counters():
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    from bugcar_image_segmentation_tpu_torch.utils import profiling

    rd = manifest.reader("fused_sepconv_launches_per_grid.x65_stream")

    class Ctx:
        trace = object()

    saved = dict(kcuda.LAUNCHES)
    try:
        with profiling.recording():
            assert rd.read(Ctx, "x") is None            # nothing counted
            kcuda.add_launches({("fused_sepconv",): 2 * 55})
            profiling.count("grids_out", 8)
            assert rd.read(Ctx, "x") == 13.75
    finally:
        kcuda.LAUNCHES.update(saved)


@pytest.mark.parametrize("trace", [0, 1])
def test_a_tiny_cell_runs_on_the_cpu(tmp_path, trace):
    root = _tiny_root(tmp_path)
    r = run.run(f"{TINY}.stream", 3000000019, 0.5, bool(trace), "cpu",
                root / "BENCHMARK.json")
    assert r["correct"] and r["failed"] == 0
    assert r["numbers"]["grids_checked"] > 0
    if not trace:
        assert set(r["metrics"]) == {"grids_per_s", "setup_s"}
        return
    got = set(r["metrics"])
    # the stream's readers, found by prefix, read this cell as SegFormer's
    assert {f"{m}.stream" for m in (
        "mfu_pct", "device_idle_pct", "engine_graph_share",
        "launches_per_grid", "upload_host_ms", "engine_host_ms",
        "grid_host_ms", "pipeline_self_ms", "drain_wait_ms")} <= got
    # on the CPU the plain version runs: no kernel launch, no graph
    assert not {"fused_sepconv_roofline.x65_stream",
                "fused_sepconv_launches_per_grid.x65_stream"} & got
    assert r["metrics"]["mfu_pct.stream"]["value"] > 0
    assert r["metrics"]["engine_graph_share.stream"]["value"] == 0


def _relu_dropped(monkeypatch):
    """Every kernel site's trailing ReLU left out (the kernel's
    ``act_out`` flag cleared): 38 of the 55 separable convs change."""
    fused = port_x.fused_sepconv

    def dropped(*args, **kw):
        return fused(*args, **dict(kw, act_out=False))

    monkeypatch.setattr(port_x, "fused_sepconv", dropped)


def _half_batch(monkeypatch):
    """Half of each batch of 4 frames left out, the other half's grids
    standing in for it."""
    batch = port_pipeline.Pipeline._program_batch

    def halved(self, frames):
        half = frames.shape[0] // 2
        grids = batch(self, frames[:half])
        return torch.cat([grids, grids])[:frames.shape[0]]

    monkeypatch.setattr(port_pipeline.Pipeline, "_program_batch", halved)


def _altered(monkeypatch):
    """The grid builder altering a corner of every grid it returns."""
    build = port_grid.OccupancyGridBuilder.build

    def altered(self, segmap):
        out = build(self, segmap).clone()
        out[..., :8, :8] = 100 - out[..., :8, :8]
        return out

    monkeypatch.setattr(port_grid.OccupancyGridBuilder, "build", altered)


@pytest.mark.parametrize("fault", [None, _relu_dropped, _half_batch,
                                   _altered],
                         ids=["sound", "relu_dropped", "half_batch",
                              "altered"])
def test_the_cells_check_fails_a_broken_batched_path(tmp_path, monkeypatch,
                                                     fault):
    """The batched path of 4 frames a backbone call, judged by the
    cell's own limit: sound, it comes out correct; broken in the kernel
    sites, the batch or the grid, not."""
    root = _tiny_root(tmp_path)
    if fault:
        fault(monkeypatch)
    r = run.run(f"{TINY}.stream", 41, 1.0, False, "cpu",
                root / "BENCHMARK.json")
    assert r["failed"] == 0 and r["correct"] is (fault is None), r["checked"]


@pytest.mark.parametrize("seed", [7001, 7002, 7003])
def test_the_control_fails_at_a_tiny_size(tmp_path, seed):
    root = _tiny_root(tmp_path)
    r = readings.control(f"{TINY}.stream", seed, "cpu",
                         root / "BENCHMARK.json")
    assert not r["correct"], r["numbers"]


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_size(card):
    for seed in (8001, 8002, 8003):
        r = readings.control(CELL, seed, "cuda")
        assert not r["correct"], (seed, r["numbers"])
