"""The check fails a broken timed path: each run goes through everything
but the look for a card, with the port broken underneath, and must come
out not correct; the same run unbroken comes out correct.

Faults, for the cells that can have them (one card, so no exchange
between chips), each where the timed path produces its answers: the grid
builder altering a corner of what it returns; a stale grid, the previous
call's handed back unchanged now and then; half of a batch left out, the
other half's grids standing in for it.
"""

import pytest
import torch

from bugcar_image_segmentation_tpu_torch import grid as port_grid
from bugcar_image_segmentation_tpu_torch import pipeline as port_pipeline
from perfbench import run


def _run(root, cell, seed=41):
    return run.run(cell, seed, 1.0, False, "cpu", root / "BENCHMARK.json")


@pytest.mark.parametrize("cell", ["tiny_seg.live", "tiny_seg.stream"])
def test_sound_runs_are_correct(tiny_root, cell):
    r = _run(tiny_root, cell)
    assert r["correct"] and r["failed"] == 0, r["checked"]


@pytest.mark.parametrize("cell", ["tiny_seg.live", "tiny_seg.stream"])
def test_an_altered_grid_fails(tiny_root, monkeypatch, cell):
    build = port_grid.OccupancyGridBuilder.build

    def altered(self, segmap):
        out = build(self, segmap).clone()
        corner = out[..., :8, :8]           # every value becomes another
        out[..., :8, :8] = 100 - corner
        return out

    monkeypatch.setattr(port_grid.OccupancyGridBuilder, "build", altered)
    r = _run(tiny_root, cell)
    assert not r["correct"], r["checked"]


def test_a_stale_grid_fails(tiny_root, monkeypatch):
    call = port_pipeline.Pipeline.__call__
    last = {}

    def stale(self, frame):
        last["n"] = last.get("n", 0) + 1
        if last["n"] % 7 == 0 and "grid" in last:
            return last["grid"]
        last["grid"] = call(self, frame)
        return last["grid"]

    monkeypatch.setattr(port_pipeline.Pipeline, "__call__", stale)
    r = _run(tiny_root, "tiny_seg.live")
    assert not r["correct"], r["checked"]


@pytest.mark.parametrize("cell", ["tiny_seg.stream"])
def test_half_a_batch_left_out_fails(tiny_root, monkeypatch, cell):
    batch = port_pipeline.Pipeline._program_batch

    def halved(self, frames):
        half = frames.shape[0] // 2
        grids = batch(self, frames[:half])
        return torch.cat([grids, grids])[:frames.shape[0]]

    monkeypatch.setattr(port_pipeline.Pipeline, "_program_batch", halved)
    r = _run(tiny_root, cell)
    assert not r["correct"], r["checked"]

