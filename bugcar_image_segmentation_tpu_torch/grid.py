"""Occupancy-grid construction: segmentation map → int8 grid, on device.

Mirrors ``bugcar_image_segmentation_tpu/grid.py`` (the reference's
``create_occupancy_grid`` / ``create_occupancy_grid_binary``, bev.py:166-246
/ 97-165).  The homography and grid geometry are calibration-time constant,
so the builder plans the warp once on the host (ops/warp.py) and every
frame is a gather, a 3x3 morph-open, a nearest binning and a value map —
torch ops on the segmap's device, over one map (H, W) or a batch
(B, H, W).  Results are bit-equal to the JAX builder.

Value semantics of the returned int8 grid (reference bev.py:242-245):
  -1 = unknown (outside camera FOV)
   0 = free (road)
 100 = occupied (flat-non-road in multiclass; non-road in binary)

The laserscan mode (reference bev.py:148, 219) ray-casts the binned grid
through constant polar plans (``ops/polar.py``): multiclass keeps, of the
occupied cells, the first hit along each ray; binary returns the pair
(plain grid, ray-cast grid).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple, Union

import torch

from .configs import CalibrationConfig, GridConfig
from .ops import device_cache, morphology, polar, resize, warp
from .utils.profiling import span


class TemplateGeometry(NamedTuple):
    """Pixel geometry shared by warp, crop/pad, and binning (the
    int-truncation arithmetic of reference bev.py:172-194)."""

    cells_w: int
    cells_h: int
    tpl_w: int
    tpl_h: int
    coord_offset: Tuple[int, int]          # (ox, oy): template → warp coords
    valid_rect: Tuple[int, int, int, int]  # (x0, x1, y0, y1) in template px


def template_geometry(cal: CalibrationConfig,
                      grid: GridConfig) -> TemplateGeometry:
    cell_px = grid.cell_px(cal.cm_per_px)
    cells_w, cells_h = grid.cells_w, grid.cells_h
    tpl_w = int(cells_w * cell_px)
    tpl_h = int(cells_h * cell_px)
    out_w, out_h = cal.output_width, cal.output_height
    left_x = int((out_w - tpl_w) / 2)
    top_y = out_h - tpl_h
    src_x0, src_y0 = max(left_x, 0), max(top_y, 0)
    dst_x0, dst_y0 = max(-left_x, 0), max(-top_y, 0)
    crop_w = min(tpl_w, out_w - src_x0)
    return TemplateGeometry(
        cells_w=cells_w, cells_h=cells_h, tpl_w=tpl_w, tpl_h=tpl_h,
        coord_offset=(src_x0 - dst_x0, src_y0 - dst_y0),
        valid_rect=(dst_x0, dst_x0 + crop_w, dst_y0, tpl_h),
    )


class OccupancyGridBuilder:
    """Segmentation map(s) → int8 occupancy grid(s) for one calibration.

    Args:
      cal: calibration (homography + BEV geometry); the expected segmap
        shape is (input_height, input_width).
      grid: metric grid geometry.
      mode: "multiclass" (3-class drivability map) or "binary" ({0,1}
        road mask).
      interpolation: "cv2_linear" (bilinear on class values, as the
        reference), "nearest", or "native" (warp only the cell-centre
        template pixels; morphology at cell resolution).
      laserscan: override the calibration's laserscan flag.
      label_scale: take the segmap at 1/label_scale of the calibrated
        input resolution (a quarter-resolution head's labels).  Only with
        ``interpolation="native"``: the cell-centre warp reads the small
        map directly, bit-identical to nearest-lifting it first.
      device: where the plan lives and the grid is built.
    """

    def __init__(self,
                 cal: CalibrationConfig,
                 grid: GridConfig,
                 mode: str = "multiclass",
                 interpolation: str = "cv2_linear",
                 laserscan: bool | None = None,
                 label_scale: int = 1,
                 device="cuda"):
        if mode not in ("multiclass", "binary"):
            raise ValueError(f"unknown mode {mode!r}")
        if label_scale != 1 and interpolation != "native":
            raise ValueError(
                "label_scale > 1 requires interpolation='native' (the "
                "parity path warps at template resolution; lift the "
                "labels to input res instead)")
        self.laserscan = cal.laserscan if laserscan is None else laserscan
        self.cal = cal
        self.grid = grid
        self.mode = mode
        self.device = torch.device(device)
        self.geom = g = template_geometry(cal, grid)
        full_shape = (cal.input_height, cal.input_width)
        self.segmap_shape = (full_shape[0] // label_scale,
                             full_shape[1] // label_scale)
        self.interpolation = interpolation
        self.label_scale = label_scale

        if interpolation == "native":
            taps = warp.cell_center_taps(
                cal.matrix_np(),
                src_shape=full_shape,
                tpl_shape=(g.tpl_h, g.tpl_w),
                cells_shape=(g.cells_h, g.cells_w),
                dst_offset=g.coord_offset,
                valid_rect=g.valid_rect,
                src_scale=label_scale,
            )
        else:
            taps = warp.perspective_taps(
                cal.matrix_np(),
                src_shape=full_shape,
                dst_shape=(g.tpl_h, g.tpl_w),
                interpolation=interpolation,
                dst_offset=g.coord_offset,
                valid_rect=g.valid_rect,
            )
        self.host_taps = taps
        self._taps = warp.taps_to(taps, self.device)

        if self.laserscan:
            ch, cw = g.cells_h, g.cells_w
            longer = float(max(cw, ch))
            centre = (cw / 2 - 1, float(ch))
            if mode == "multiclass":
                # reference bev.py:219 passes dsize=(-1,-1) → auto size.
                pw, ph = polar.auto_polar_dsize(longer)
            else:
                # reference bev.py:148 passes the grid's own (w, h).
                pw, ph = cw, ch
            self._fwd_plan = polar.plan_to(polar.polar_maps(
                (ch, cw), (pw, ph), centre, longer), self.device)
            self._inv_plan = polar.plan_to(polar.inverse_polar_maps(
                (ch, cw), (ph, pw), centre, longer), self.device)
            self._polar_shape = (ph, pw)

    def build(self, segmap: torch.Tensor
              ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """(H, W) or (B, H, W) uint8 segmap(s) on the builder's device →
        int8 grid(s) (cells_h, cells_w); in binary laserscan mode the pair
        (plain grid(s), ray-cast grid(s)), as the reference returns it
        (bev.py:164)."""
        with span("grid.build"):
            return self._build(segmap)

    def _build(self, segmap: torch.Tensor
               ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        if tuple(segmap.shape[-2:]) != self.segmap_shape:
            raise ValueError(f"segmap shape {tuple(segmap.shape)} != "
                             f"expected {self.segmap_shape}")
        g = self.geom
        shifted = (segmap + 1).to(torch.uint8)
        template = warp.apply_warp(shifted, self._taps)

        if self.mode == "multiclass":
            occupied = ((template == 1) | (template == 3)).to(torch.uint8)
        else:
            occupied = (template == 1).to(torch.uint8)
        opened = morphology.morph_open(occupied, (3, 3))
        # Opening never adds pixels, so the saturated subtract of
        # reference bev.py:134/204 is just ">".
        speckles = occupied > opened
        template = torch.where(speckles, torch.full_like(template, 2),
                               template)

        if self.interpolation == "native":
            cells = template
        else:
            cells = resize.resize_nearest(template, (g.cells_h, g.cells_w))

        if self.mode == "multiclass":
            if self.laserscan:
                new = torch.where(cells != 3, cells,
                                  self._ray_cast(cells, 3, 1))
            else:
                new = torch.where(cells == 3, torch.ones_like(cells), cells)
            vals = 200 - new.to(torch.int32) * 100
            return torch.where(new == 0, torch.full_like(vals, -1),
                               vals).to(torch.int8)

        # binary mode (reference bev.py:97-165): 255 = unknown wraps to -1;
        # the value map comes before the optional laserscan pass.
        vals = cells.to(torch.int32) * 100
        occ_u8 = torch.where(vals == 0, torch.full_like(vals, 255),
                             200 - vals).to(torch.uint8)
        if not self.laserscan:
            return occ_u8.to(torch.int8)
        new = self._ray_cast(occ_u8, 100, 100).to(torch.int8)
        new = torch.where(occ_u8 == 255, torch.full_like(new, -1), new)
        return occ_u8.to(torch.int8), new

    def _ray_cast(self, cells: torch.Tensor, target: int, value: int
                  ) -> torch.Tensor:
        """The laserscan pass: cells to polar, the first ``target`` along
        each ray drawn as ``value`` (a 5-pixel diamond), back to cells."""
        pol = polar.apply_gather(cells, self._fwd_plan)
        has, col = polar.first_hit_per_row(pol, target)
        canvas = polar.splat_first_hits(has, col, self._polar_shape, value,
                                        torch.uint8)
        return polar.apply_gather(canvas, self._inv_plan)

    def __call__(self, segmap
                 ) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
        """Build grid(s) from a (H, W) or (B, H, W) map (array or tensor)."""
        segmap = torch.as_tensor(segmap, dtype=torch.uint8,
                                 device=self.device)
        if segmap.ndim not in (2, 3):
            raise ValueError(f"segmap must be (H, W) or (B, H, W), "
                             f"got {tuple(segmap.shape)}")
        return self.build(segmap)


@device_cache(maxsize=8)
def _cached_builder(cal: CalibrationConfig, grid: GridConfig, mode: str,
                    interpolation: str, device: str) -> OccupancyGridBuilder:
    return OccupancyGridBuilder(cal, grid, mode=mode,
                                interpolation=interpolation, device=device)


def create_occupancy_grid(segmap, cal: CalibrationConfig, grid: GridConfig,
                          interpolation: str = "cv2_linear", device="cuda"):
    """One-shot functional API mirroring reference bev.py:166: a
    multiclass grid (or the laserscan grid of a laserscan calibration)
    from a (H, W) or (B, H, W) segmap, through a builder cached per
    calibration, grid, interpolation and device."""
    return _cached_builder(cal, grid, "multiclass", interpolation,
                           str(device))(segmap)


def create_occupancy_grid_binary(segmap, cal: CalibrationConfig,
                                 grid: GridConfig,
                                 interpolation: str = "cv2_linear",
                                 device="cuda"):
    """One-shot functional API mirroring reference bev.py:97: the binary
    grid (with a laserscan calibration, the pair of plain and ray-cast
    grids)."""
    return _cached_builder(cal, grid, "binary", interpolation,
                           str(device))(segmap)


__all__ = ["OccupancyGridBuilder", "TemplateGeometry", "template_geometry",
           "create_occupancy_grid", "create_occupancy_grid_binary"]
