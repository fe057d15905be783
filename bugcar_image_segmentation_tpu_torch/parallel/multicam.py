"""The camera rig sharded over ranks: each rank runs its cameras.

Port of ``bugcar_image_segmentation_tpu/parallel/multicam.py``: BASELINE
config 4 spread over devices.  The cameras split evenly over an axis of
the mesh; each rank runs the single-device rig body
(``pipeline.MultiCameraPipeline``: its cameras through the backbone,
frame by frame where ``Engine.frame_by_frame`` says so, one grid each,
stitched by elementwise max), and a max all-reduce over the axis merges
the ranks' grids, as the JAX program's ``pmax`` does.  Every rank returns
the same stitched grid.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.distributed as dist

from ..configs import CalibrationConfig, GridConfig
from ..models.api import frames_to_device
from ..pipeline import MultiCameraPipeline
from .mesh import Mesh


class ShardedMultiCameraPipeline:
    """N cameras sharded over ``axis`` of ``mesh`` → one stitched vehicle
    grid on every rank.  The cameras must divide evenly over the axis,
    and every camera must share the grid geometry."""

    def __init__(self, engine, cals: Sequence[CalibrationConfig],
                 grid_cfg: GridConfig, mesh: Mesh, axis: str = "data",
                 interpolation: str = "cv2_linear"):
        n_cam, n_dev = len(cals), mesh.size(axis)
        if n_cam % n_dev != 0:
            raise ValueError(f"{n_cam} cameras do not divide over "
                             f"{n_dev} devices")
        self.engine = engine
        self.mesh, self.axis = mesh, axis
        self.n_cameras = n_cam
        per = n_cam // n_dev
        self.first = mesh.index(axis) * per
        # every camera's builder (the geometry check); this rank's kept
        self.local = MultiCameraPipeline(engine, cals, grid_cfg,
                                         interpolation=interpolation)
        self.local.builders = self.local.builders[self.first:
                                                  self.first + per]
        self.group = mesh.group(axis)

    @torch.no_grad()
    def __call__(self, frames_bgr) -> torch.Tensor:
        """(N_cam, H, W, 3) uint8 BGR, every camera's frame → the stitched
        int8 grid (the same on every rank), on the engine's device."""
        frames = frames_to_device(frames_bgr, self.engine.device)
        if frames.dim() != 4 or frames.shape[0] != self.n_cameras:
            raise ValueError(f"want ({self.n_cameras}, H, W, 3) frames, one "
                             f"per camera; got {tuple(frames.shape)}")
        mine = frames[self.first:self.first + len(self.local.builders)]
        grid = self.local(mine)
        if self.mesh.size(self.axis) > 1:
            dist.all_reduce(grid, op=dist.ReduceOp.MAX, group=self.group)
        return grid


__all__ = ["ShardedMultiCameraPipeline"]
