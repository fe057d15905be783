"""Field-of-view footprint and outline in grid space.

Port of ``bugcar_image_segmentation_tpu/fov.py`` (the working form of the
reference's ``create_skeleton``, image_processing_utils.py:95-105): the
warp is a precomputed gather plan, so the FOV footprint is "which template
pixels have a valid warp tap" -- read off the port's own nearest-neighbour
plan (``ops/warp.perspective_taps``, validity as a nonzero weight), host
numpy, no warp at run time -- binned to cells as the grid build bins, and
the outline is its morphological gradient.
"""

from __future__ import annotations

import numpy as np

from .configs import CalibrationConfig, GridConfig
from .grid import template_geometry
from .ops import warp


def fov_mask(cal: CalibrationConfig, grid: GridConfig) -> np.ndarray:
    """{0,1} uint8 (cells_h, cells_w): grid cells inside the camera FOV.

    A cell is visible iff the template pixel its nearest binning reads
    has an inverse-homography sample inside the source image."""
    g = template_geometry(cal, grid)
    taps = warp.perspective_taps(
        cal.matrix_np(), src_shape=(cal.input_height, cal.input_width),
        dst_shape=(g.tpl_h, g.tpl_w), interpolation="nearest",
        dst_offset=g.coord_offset, valid_rect=g.valid_rect)
    valid = taps.weights > 0                      # (tpl_h, tpl_w)
    # the grid build's nearest binning (ops/resize.resize_nearest)
    ys = np.minimum((np.arange(g.cells_h) * (valid.shape[0] / g.cells_h))
                    .astype(np.int64), valid.shape[0] - 1)
    xs = np.minimum((np.arange(g.cells_w) * (valid.shape[1] / g.cells_w))
                    .astype(np.int64), valid.shape[1] - 1)
    return valid[ys][:, xs].astype(np.uint8)


def fov_outline(cal: CalibrationConfig, grid: GridConfig) -> np.ndarray:
    """{0,1} uint8 one-cell-thick outline of the FOV footprint."""
    mask = fov_mask(cal, grid)
    padded = np.pad(mask, 1)
    eroded = np.minimum.reduce([
        padded[:-2, 1:-1], padded[2:, 1:-1],
        padded[1:-1, :-2], padded[1:-1, 2:], mask])
    return (mask & (eroded == 0)).astype(np.uint8)


__all__ = ["fov_mask", "fov_outline"]
