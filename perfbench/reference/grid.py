"""Plain frame preprocessing, class remap, calibration and occupancy grid.

- Preprocessing: the camera's uint8 BGR frame resized to the model's input
  by half-pixel-centre bilinear (edges replicated), BGR → RGB, / 256,
  ImageNet mean and std.
- Remap: argmax over the classes (the first maximum wins); road (0) and
  lane marking (1) → 1, pavement (2) and vegetation (9) → 0, every other
  class → 2.
- Calibration: the homography that takes a fiducial tile seen in the
  camera image to its ideal bird's-eye-view spot (the tile turned by the
  camera's yaw), solved as the 8-unknown linear system with H[2, 2] = 1
  from corners rounded to float32, as cv2.getPerspectiveTransform does.
- Grid: the label map + 1 warped into the BEV template by
  cv2.warpPerspective's rule (each template pixel mapped back through
  the inverse homography in float32 fused multiply-adds, bilinear on the
  class values, zero outside the map or the template's valid rectangle,
  rounded half to even), occupied = values 1 or 3, its 3x3 opening's
  removed pixels set to 2, nearest binning to the cells, and the value
  map 0 → -1 (unknown), 1 → 100 (occupied), 2 → 0 (free).

Imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from .common import resize_bilinear

ROAD_CLASSES, FLAT_CLASSES = (0, 1), (2, 9)


def preprocess(frames: torch.Tensor, hw: Tuple[int, int],
               mean, std) -> torch.Tensor:
    """(N, H, W, 3) uint8 BGR → (N, h, w, 3) float32 normalised RGB."""
    x = resize_bilinear(frames.float().permute(0, 3, 1, 2), hw)
    x = x.permute(0, 2, 3, 1).flip(-1) / 256.0
    m = torch.tensor(mean, dtype=torch.float32, device=x.device)
    s = torch.tensor(std, dtype=torch.float32, device=x.device)
    return (x - m) / s


def drivability(logits: torch.Tensor) -> torch.Tensor:
    """(N, h, w, C) logits → (N, h, w) uint8 in {0 flat, 1 road, 2 other}."""
    cls = torch.argmax(logits, -1)
    table = torch.full((logits.shape[-1],), 2, dtype=torch.uint8)
    table[list(FLAT_CLASSES)] = 0
    table[list(ROAD_CLASSES)] = 1
    return table.to(logits.device)[cls]


# -- calibration ------------------------------------------------------------

def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i in range(4):
        (x, y), (u, v) = src[i], dst[i]
        a[2 * i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[2 * i], b[2 * i + 1] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _bev_corners(cal: dict, yaw: float) -> np.ndarray:
    """The tile's ideal BEV corners, ordered left of the turned x-axis
    then right of it, each side by position along the axis."""
    width, height = cal["bev_size"]
    cm = cal["cm_per_px"]
    half = cal["tile_cm"] / cm / 2.0
    corners = np.array([[half, half], [half, -half], [-half, -half],
                        [-half, half]])
    rot = np.array([[np.cos(yaw), -np.sin(yaw)], [np.sin(yaw), np.cos(yaw)]])
    target = np.array([width / 2.0 + cal["target_cm"][0] / cm,
                       height - cal["target_cm"][1] / cm])
    pts = corners @ rot.T + target
    # coordinates along (x) and across (y) the turned axis
    back = np.array([[np.cos(-yaw), -np.sin(-yaw)],
                     [np.sin(-yaw), np.cos(-yaw)]])
    local = (pts - target) @ back.T
    left = sorted((i for i in range(4) if local[i, 1] >= 0),
                  key=lambda i: local[i, 0])
    right = sorted((i for i in range(4) if local[i, 1] < 0),
                   key=lambda i: local[i, 0])
    return pts[left + right]


def homography(cal: dict, input_hw: Tuple[int, int], yaw: float
               ) -> np.ndarray:
    """The camera → BEV homography of a camera turned by ``yaw``, for a
    label map of ``input_hw``; ``cal["tile_in_image"]`` holds the tile's
    corners as fractions of (w, h)."""
    h, w = input_hw
    tile = np.array(cal["tile_in_image"], np.float64) * np.array([w, h])
    f32 = np.float32
    return _homography(tile.astype(f32).astype(np.float64),
                       _bev_corners(cal, yaw).astype(f32).astype(np.float64))


# -- the grid ---------------------------------------------------------------

def _fma32(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


class GridReference:
    """Label map (N, h, w) uint8 → int8 grids (N, cells_h, cells_w) for one
    calibrated camera."""

    def __init__(self, cal: dict, grid: dict, input_hw: Tuple[int, int],
                 yaw: float, device):
        cm = cal["cm_per_px"]
        cells_w = int(grid["width_m"] / grid["cell_m"])
        cells_h = int(grid["height_m"] / grid["cell_m"])
        cell_px = grid["cell_m"] * 100.0 / cm
        tpl_w, tpl_h = int(cells_w * cell_px), int(cells_h * cell_px)
        out_w, out_h = cal["bev_size"]
        left, top = int((out_w - tpl_w) / 2), out_h - tpl_h
        ox = max(left, 0) - max(-left, 0)
        oy = max(top, 0) - max(-top, 0)
        x0, y0 = max(-left, 0), max(-top, 0)
        x1 = x0 + min(tpl_w, out_w - max(left, 0))
        # each template pixel back through the inverse homography
        mi = np.linalg.inv(homography(cal, input_hw, yaw)).astype(np.float32)
        xs = np.broadcast_to((np.arange(tpl_w, dtype=np.float32)
                              + np.float32(ox))[None], (tpl_h, tpl_w))
        ys = np.broadcast_to((np.arange(tpl_h, dtype=np.float32)
                              + np.float32(oy))[:, None], (tpl_h, tpl_w))
        den = _fma32(mi[2, 0], xs, _fma32(mi[2, 1], ys, mi[2, 2]))
        fx = (_fma32(mi[0, 0], xs, _fma32(mi[0, 1], ys, mi[0, 2]))
              / den).astype(np.float64)
        fy = (_fma32(mi[1, 0], xs, _fma32(mi[1, 1], ys, mi[1, 2]))
              / den).astype(np.float64)
        cols = np.arange(tpl_w)[None]
        rows = np.arange(tpl_h)[:, None]
        inside = (cols >= x0) & (cols < x1) & (rows >= y0) & (rows < tpl_h)
        ix, iy = np.floor(fx).astype(np.int64), np.floor(fy).astype(np.int64)
        ax, ay = fx - ix, fy - iy
        h, w = input_hw
        taps = []
        for dy, dx, wt in ((0, 0, (1 - ax) * (1 - ay)), (0, 1, ax * (1 - ay)),
                           (1, 0, (1 - ax) * ay), (1, 1, ax * ay)):
            ty, tx = iy + dy, ix + dx
            ok = (tx >= 0) & (tx < w) & (ty >= 0) & (ty < h) & inside
            index = np.clip(ty, 0, h - 1) * w + np.clip(tx, 0, w - 1)
            taps.append((torch.as_tensor(index, device=device),
                         torch.as_tensor(np.where(ok, wt, 0.0)
                                         .astype(np.float32), device=device)))
        self.taps = taps
        self.bins = (torch.as_tensor(np.minimum(
            (np.arange(cells_h) * (tpl_h / cells_h)).astype(np.int64),
            tpl_h - 1), device=device), torch.as_tensor(np.minimum(
                (np.arange(cells_w) * (tpl_w / cells_w)).astype(np.int64),
                tpl_w - 1), device=device))

    def __call__(self, labels: torch.Tensor) -> torch.Tensor:
        flat = (labels.reshape(labels.shape[0], -1).float() + 1.0)
        acc = None
        for index, wt in self.taps:
            term = flat[:, index] * wt
            acc = term if acc is None else acc + term
        tpl = torch.round(acc).clamp(0, 255).to(torch.uint8)
        occupied = ((tpl == 1) | (tpl == 3)).float()[:, None]
        # erode then dilate; max_pool2d pads with -inf, so the border
        # never constrains a window
        opened = F.max_pool2d(-F.max_pool2d(-occupied, 3, 1, 1), 3, 1, 1)
        tpl = torch.where((occupied > opened)[:, 0], torch.full_like(tpl, 2),
                          tpl)
        cells = tpl.index_select(1, self.bins[0]).index_select(2, self.bins[1])
        cells = torch.where(cells == 3, torch.ones_like(cells), cells)
        vals = 200 - cells.to(torch.int32) * 100
        return torch.where(cells == 0, torch.full_like(vals, -1),
                           vals).to(torch.int8)


    def cell_margins(self, gaps: torch.Tensor) -> torch.Tensor:
        """(N, h*w) per-pixel margins → (N, cells_h, cells_w): the smallest
        margin among the label pixels a cell's value depends on (the
        bilinear taps of the 5x5 template pixels its opening reads)."""
        big = torch.full_like(self.taps[0][1], float("inf"))
        tap = None
        for index, wt in self.taps:
            g = torch.where(wt > 0, gaps[:, index], big)
            tap = g if tap is None else torch.minimum(tap, g)
        near = -F.max_pool2d(-tap[:, None], 5, 1, 2)[:, 0]
        return near.index_select(1, self.bins[0]).index_select(2, self.bins[1])


def grid_references(cfg: dict, yaws, device) -> Dict[float, GridReference]:
    hw = (cfg["input_height"], cfg["input_width"])
    return {y: GridReference(cfg["calibration"], cfg["grid"], hw, y, device)
            for y in yaws}
