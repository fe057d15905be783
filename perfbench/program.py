"""The system under test: the PyTorch and CUDA port, built from a
configuration file through its own entry points.

The engine is ``build_engine(<engine>, ModelConfig(...), variables=...)``
over the benchmark's seeded weights; each camera is a ``Pipeline`` over
that engine with its own calibration, solved by the port's geometry from
the configuration's fiducial tile and the camera's yaw.  :class:`Spans`
puts the harness's profiler ranges around this instance's
``engine.segment_head`` and each ``builder.build`` (the port is not
edited) and counts the frames that went through the engine.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

ENGINE_SPAN = "perfbench.engine"
GRID_SPAN = "perfbench.grid"


def engine(cfg: dict, weights: Dict[str, torch.Tensor], device):
    from bugcar_image_segmentation_tpu_torch.configs import ModelConfig
    from bugcar_image_segmentation_tpu_torch.models.api import build_engine

    mc = ModelConfig(name=cfg["engine"], input_width=cfg["input_width"],
                     input_height=cfg["input_height"],
                     num_classes=cfg["num_classes"], dtype=cfg["dtype"],
                     image_mean=tuple(cfg["image_mean"]),
                     image_std=tuple(cfg["image_std"]))
    return build_engine(cfg["engine"], mc, variables=weights, device=device)


def calibration(cfg: dict, yaw: float):
    from bugcar_image_segmentation_tpu_torch import geometry
    from bugcar_image_segmentation_tpu_torch.configs import CalibrationConfig

    c = cfg["calibration"]
    w, h = cfg["input_width"], cfg["input_height"]
    cal = CalibrationConfig(
        input_shape=(w, h), output_shape=tuple(c["bev_size"]),
        dist2target=tuple(c["target_cm"]), tile_length=c["tile_cm"],
        cm_per_px=c["cm_per_px"], yaw=yaw)
    tile = np.array(c["tile_in_image"], np.float64) * np.array([w, h])
    return cal.with_matrix(geometry.calculate_transform_matrix(
        tile, output_shape=cal.output_shape, dist2target=cal.dist2target,
        tile_length=cal.tile_length, cm_per_px=cal.cm_per_px, yaw=yaw))


def pipelines(eng, cfg: dict, yaws: List[float]):
    from bugcar_image_segmentation_tpu_torch.configs import GridConfig
    from bugcar_image_segmentation_tpu_torch.pipeline import Pipeline

    grid = GridConfig(**cfg["grid"])
    return [Pipeline(eng, calibration(cfg, y), grid) for y in yaws]


class Spans:
    """Profiler ranges around the engine and the grid builders of these
    pipelines; ``frames`` counts what the engine was handed, ``calls`` in
    how many calls."""

    def __init__(self, pipes):
        self.frames = self.calls = 0
        eng = pipes[0].engine
        head = eng.segment_head

        def segment_head(frames, *args, **kwargs):
            self.frames += frames.shape[0]
            self.calls += 1
            with torch.profiler.record_function(ENGINE_SPAN):
                return head(frames, *args, **kwargs)

        eng.segment_head = segment_head
        for pipe in pipes:
            self._wrap(pipe.builder)

    @staticmethod
    def _wrap(builder) -> None:
        build = builder.build

        def wrapped(segmap):
            with torch.profiler.record_function(GRID_SPAN):
                return build(segmap)

        builder.build = wrapped
