"""Polar warps and laserscan-style first-hit ray casting.

Port of ``bugcar_image_segmentation_tpu/ops/polar.py``.  The reference
emulates a 2-D lidar by polar-warping the occupancy grid, keeping only the
first obstacle along each ray, and warping back (reference bev.py:145-164,
216-240): ``cv2.warpPolar`` → ``numpy_indexed`` group-by-min → a Python
loop of ``cv2.circle`` draws → inverse ``cv2.warpPolar``.

The polar coordinate maps are shape-constant, so they are built once on
the host in numpy (:func:`polar_maps`, :func:`inverse_polar_maps`) with
cv2's arithmetic, including its ``fastAtan2`` polynomial in float32 (bit
for bit the JAX package's, so ray indices match cv2's); the per-frame work
is torch ops on the grid's device: a gather to polar, a masked row
minimum (first hit per ray), the 5-pixel diamond splat (what
``cv2.circle(r=1, filled)`` draws), and a gather back.  Every device op
takes leading batch axes.

Both polar warps sample nearest-neighbour: the reference's flags
``cv2.WARP_POLAR_LINEAR`` (0) and ``cv2.WARP_INVERSE_MAP`` (16) leave
``flags & INTER_MAX`` at INTER_NEAREST.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

_F32 = np.float32


def auto_polar_dsize(max_radius: float) -> Tuple[int, int]:
    """cv2.warpPolar dsize=(-1,-1) rule: (round(R), round(R*pi)) (w, h)."""
    w = int(np.rint(max_radius))
    h = int(np.rint(max_radius * np.pi))
    return w, h


def fast_atan2_deg(y: np.ndarray, x: np.ndarray) -> np.ndarray:
    """OpenCV's fastAtan2 (degrees, float32): a 7th-order polynomial per
    octant, accurate to ~0.3 degrees, replicated exactly."""
    rad2deg = 180.0 / np.pi
    p1 = _F32(0.9997878412794807 * rad2deg)
    p3 = _F32(-0.3258083974640975 * rad2deg)
    p5 = _F32(0.1555786518463281 * rad2deg)
    p7 = _F32(-0.04432655554792128 * rad2deg)
    eps = _F32(2.220446049250313e-16)  # (float)DBL_EPSILON

    x = x.astype(_F32)
    y = y.astype(_F32)
    ax, ay = np.abs(x), np.abs(y)
    lo = np.minimum(ax, ay) / (np.maximum(ax, ay) + eps)
    c2 = lo * lo
    poly = (((p7 * c2 + p5) * c2 + p3) * c2 + p1) * lo
    a = np.where(ax >= ay, poly, _F32(90.0) - poly)
    a = np.where(x < 0, _F32(180.0) - a, a)
    a = np.where(y < 0, _F32(360.0) - a, a)
    return a.astype(_F32)


class GatherPlan(NamedTuple):
    """Flat gather indices + validity for one constant resampling (host
    numpy arrays; :func:`plan_to` moves them to a device)."""

    indices: np.ndarray  # int32 (H, W) into the flattened source
    valid: np.ndarray    # bool (H, W); invalid samples read as 0


def _nearest_plan(map_x: np.ndarray, map_y: np.ndarray,
                  src_shape: Tuple[int, int]) -> GatherPlan:
    sh, sw = src_shape
    ix = np.rint(map_x.astype(np.float64)).astype(np.int64)
    iy = np.rint(map_y.astype(np.float64)).astype(np.int64)
    valid = (ix >= 0) & (ix < sw) & (iy >= 0) & (iy < sh)
    flat = (np.clip(iy, 0, sh - 1) * sw + np.clip(ix, 0, sw - 1))
    return GatherPlan(indices=flat.astype(np.int32), valid=valid)


@functools.lru_cache(maxsize=16)
def polar_maps(src_shape: Tuple[int, int],
               dsize: Tuple[int, int],
               center: Tuple[float, float],
               max_radius: float) -> GatherPlan:
    """Forward linear-polar gather plan (cartesian → polar).

    polar(phi, rho) samples src at
      x = cx + rho*Kmag * cos(phi*Kangle),  y = cy + rho*Kmag * sin(...)
    with Kangle = 2*pi/polar_h, Kmag = max_radius/polar_w, nearest sampling.

    Args:
      src_shape: (H, W) of the cartesian source.
      dsize: (w, h) of the polar image; (-1, -1) → cv2's auto rule.
      center: (cx, cy).
      max_radius: radius in source pixels mapped to the last polar column.
    """
    pw, ph = dsize
    if pw <= 0 or ph <= 0:
        pw, ph = auto_polar_dsize(max_radius)
    k_angle = 2.0 * np.pi / ph
    k_mag = max_radius / pw
    phi = np.arange(ph, dtype=np.float64)[:, None] * k_angle
    rho = np.arange(pw, dtype=np.float64)[None, :] * k_mag
    # cv2 builds these maps in float32.
    mx = (center[0] + rho * np.cos(phi)).astype(_F32)
    my = (center[1] + rho * np.sin(phi)).astype(_F32)
    return _nearest_plan(mx, my, src_shape)


@functools.lru_cache(maxsize=16)
def inverse_polar_maps(dst_shape: Tuple[int, int],
                       polar_shape: Tuple[int, int],
                       center: Tuple[float, float],
                       max_radius: float) -> GatherPlan:
    """Inverse linear-polar gather plan (polar → cartesian).

    cart(y, x) samples polar at
      rho = |p - c| / Kmag,  phi = fastAtan2(dy, dx) / Kangle
    using cv2's float32 magnitude and fastAtan2-in-degrees→radians phase.

    Args:
      dst_shape: (H, W) of the cartesian output.
      polar_shape: (H, W) of the polar source.
      center, max_radius: as in the forward transform.
    """
    dh, dw = dst_shape
    ph, pw = polar_shape
    k_angle = _F32(2.0 * np.pi / ph)
    k_mag = _F32(max_radius / pw)
    xs = np.arange(dw, dtype=_F32)[None, :] - _F32(center[0])
    ys = np.arange(dh, dtype=_F32)[:, None] - _F32(center[1])
    xs = np.broadcast_to(xs, (dh, dw))
    ys = np.broadcast_to(ys, (dh, dw))
    mag = np.sqrt(xs * xs + ys * ys, dtype=_F32)
    ang = fast_atan2_deg(ys, xs) * _F32(np.pi / 180.0)  # cv2 phase() scaling
    rho = (mag / k_mag).astype(_F32)
    phi = (ang / k_angle).astype(_F32)
    return _nearest_plan(rho, phi, (ph, pw))


def plan_to(plan: GatherPlan, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """A host plan as (int64 flat indices, bool valid) tensors on
    ``device``."""
    return (torch.as_tensor(plan.indices.astype(np.int64), device=device),
            torch.as_tensor(plan.valid, device=device))


def apply_gather(src: torch.Tensor,
                 plan: Tuple[torch.Tensor, torch.Tensor]) -> torch.Tensor:
    """Resample (..., H, W) through a constant gather plan (:func:`plan_to`)
    to (..., h, w); invalid samples read 0."""
    idx, valid = plan
    flat = src.reshape(*src.shape[:-2], -1)
    vals = flat[..., idx.reshape(-1)].reshape(*src.shape[:-2], *idx.shape)
    return torch.where(valid, vals, torch.zeros((), dtype=src.dtype,
                                                device=src.device))


def first_hit_per_row(polar_img: torch.Tensor, target_value
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Smallest column index equal to ``target_value`` in each row of
    (..., H, W): a masked row minimum (the reference's
    ``npi.group_by(rows).min(cols)``, bev.py:156, 229).

    Returns (has, col): bool (..., H) whether the row has a hit, int64
    (..., H) column of the first hit (w - 1 where ``has`` is False)."""
    w = polar_img.shape[-1]
    cols = torch.arange(w, device=polar_img.device)
    col = torch.where(polar_img == target_value, cols,
                      torch.full_like(cols, w)).amin(-1)
    return col < w, col.clamp(max=w - 1)


def splat_first_hits(has: torch.Tensor, col: torch.Tensor,
                     shape: Tuple[int, int], value, dtype: torch.dtype
                     ) -> torch.Tensor:
    """A filled radius-1 circle (the 5-pixel diamond cv2.circle draws) of
    ``value`` at (row, col[row]) of each row with a hit, on a (..., h, w)
    canvas of zeros (the reference's draw loop, bev.py:157-158,
    232-233)."""
    h, w = shape
    cols = torch.arange(w, device=col.device)

    def row_mask(has_r, col_r, max_dx):
        return has_r[..., None] & ((cols - col_r[..., None]).abs() <= max_dx)

    pad_has = torch.zeros_like(has[..., :1])
    pad_col = torch.zeros_like(col[..., :1])
    centre = row_mask(has, col, 1)
    above = row_mask(torch.cat([has[..., 1:], pad_has], -1),
                     torch.cat([col[..., 1:], pad_col], -1), 0)
    below = row_mask(torch.cat([pad_has, has[..., :-1]], -1),
                     torch.cat([pad_col, col[..., :-1]], -1), 0)
    mask = centre | above | below
    return torch.where(mask, torch.tensor(value, dtype=dtype,
                                          device=col.device),
                       torch.tensor(0, dtype=dtype, device=col.device))


__all__ = [
    "auto_polar_dsize", "fast_atan2_deg", "polar_maps",
    "inverse_polar_maps", "plan_to", "apply_gather", "first_hit_per_row",
    "splat_first_hits", "GatherPlan",
]
