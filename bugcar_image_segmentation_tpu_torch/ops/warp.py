"""Perspective (homography) warp as a precomputed gather plan.

Mirrors ``bugcar_image_segmentation_tpu/ops/warp.py``.  The homography is
calibration-time constant, so all address arithmetic happens once on the
host, in numpy, with the same float32 fma chain that reproduces
cv2.warpPerspective's inverse map (``_fma32``); the host plans here are
copies of the JAX package's and give identical index and weight arrays.
The device side packs each source pixel's 2x2 neighbourhood, gathers one
4-vector per output pixel, and blends with the plan's weights, rounding
half-to-even and saturating to u8 as cv2 does.  Out-of-source samples are
0 (BORDER_CONSTANT), which the grid semantics rely on (0 = outside the
field of view, reference bev.py:177).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _fma32(a, b, c):
    """Float32 fused multiply-add (single rounding), emulated via float64."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def cv2_inverse_coords(matrix: np.ndarray,
                       dst_width: int,
                       dst_height: int,
                       dst_offset: Tuple[int, int] = (0, 0),
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Source sampling coordinates (fX, fY), float32 (dst_h, dst_w), of
    each destination pixel under cv2.warpPerspective's inverse map
    (``matrix`` maps src→dst; ``dst_offset`` shifts the dst pixel grid)."""
    ox, oy = dst_offset
    xs = (np.arange(dst_width, dtype=np.float32) + np.float32(ox))[None, :]
    ys = (np.arange(dst_height, dtype=np.float32) + np.float32(oy))[:, None]
    xs = np.broadcast_to(xs, (dst_height, dst_width))
    ys = np.broadcast_to(ys, (dst_height, dst_width))
    return _inverse_coords_at(matrix, xs, ys)


def _inverse_coords_at(matrix: np.ndarray, xs: np.ndarray, ys: np.ndarray
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """cv2's fma-contracted inverse map at arbitrary dst coordinates."""
    minv = np.linalg.inv(np.asarray(matrix, dtype=np.float64))
    mi = minv.astype(np.float32)
    den = _fma32(mi[2, 0], xs, _fma32(mi[2, 1], ys, np.float32(mi[2, 2])))
    fx = _fma32(mi[0, 0], xs, _fma32(mi[0, 1], ys, np.float32(mi[0, 2]))) / den
    fy = _fma32(mi[1, 0], xs, _fma32(mi[1, 1], ys, np.float32(mi[1, 2]))) / den
    return fx, fy


class WarpTaps(NamedTuple):
    """Precomputed gather plan for one warp (host numpy arrays).

    ``indices``: int32 (H, W) flattened source index — the 2x2 block's
    top-left corner (bilinear) or the nearest pixel (nearest).
    ``weights``: float32 — (H, W, 4) block-layout bilinear weights (order
    TL, TR, BL, BR; invalid taps hold weight 0), or (H, W) 0/1 validity
    for nearest.
    """

    indices: np.ndarray
    weights: np.ndarray
    src_shape: Tuple[int, int]
    mode: str


def perspective_taps(matrix: np.ndarray,
                     src_shape: Tuple[int, int],
                     dst_shape: Tuple[int, int],
                     interpolation: str = "cv2_linear",
                     dst_offset: Tuple[int, int] = (0, 0),
                     valid_rect: Optional[Tuple[int, int, int, int]] = None,
                     ) -> WarpTaps:
    """Gather plan for warping src (H, W) into dst (H, W).

    ``interpolation`` is "cv2_linear" (bilinear on values, the reference's
    behaviour for label maps) or "nearest".  ``dst_offset`` fuses the
    crop/pad of reference bev.py:183-194 into the warp; pixels outside
    ``valid_rect`` (x0, x1, y0, y1), half-open, are forced to 0.
    """
    sh, sw = src_shape
    dh, dw = dst_shape
    fx, fy = cv2_inverse_coords(matrix, dw, dh, dst_offset)
    cols = np.broadcast_to(np.arange(dw)[None, :], (dh, dw))
    rows = np.broadcast_to(np.arange(dh)[:, None], (dh, dw))
    window = _window_mask(cols, rows, valid_rect)
    indices, weights = _plan_from_coords(fx, fy, window, src_shape,
                                         interpolation)
    return WarpTaps(indices=indices, weights=weights,
                    src_shape=(sh, sw), mode=interpolation)


def _window_mask(cols: np.ndarray, rows: np.ndarray,
                 valid_rect: Optional[Tuple[int, int, int, int]]
                 ) -> np.ndarray:
    if valid_rect is None:
        return np.ones(cols.shape, dtype=bool)
    x0, x1, y0, y1 = valid_rect
    return (cols >= x0) & (cols < x1) & (rows >= y0) & (rows < y1)


def _plan_from_coords(fx: np.ndarray, fy: np.ndarray, window: np.ndarray,
                      src_shape: Tuple[int, int], interpolation: str,
                      src_scale: int = 1
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Indices/weights for sampling src at float coords (fx, fy).

    ``src_scale`` > 1 plans against a source of shape
    ``(sh // src_scale, sw // src_scale)`` whose nearest-lift is the
    nominal (sh, sw) source; every tap address maps through
    ``// src_scale``, bit-identical to applying the scale-1 plan to the
    lifted map.
    """
    sh, sw = src_shape
    if src_scale != 1 and (sh % src_scale or sw % src_scale):
        raise ValueError(f"src_shape {src_shape} not divisible by "
                         f"src_scale {src_scale}")
    qh, qw = sh // src_scale, sw // src_scale
    fx64 = fx.astype(np.float64)
    fy64 = fy.astype(np.float64)

    def in_bounds(iy, ix):
        return (ix >= 0) & (ix < sw) & (iy >= 0) & (iy < sh)

    if interpolation == "nearest":
        # cv2 INTER_NEAREST: round-half-to-even of the float coordinate.
        ix = np.rint(fx64).astype(np.int64)
        iy = np.rint(fy64).astype(np.int64)
        valid = in_bounds(iy, ix) & window
        indices = (np.clip(iy, 0, sh - 1) // src_scale * qw
                   + np.clip(ix, 0, sw - 1) // src_scale).astype(np.int32)
        weights = valid.astype(np.float32)
    elif interpolation == "cv2_linear":
        ix = np.floor(fx64).astype(np.int64)
        iy = np.floor(fy64).astype(np.int64)
        ffx = fx64 - ix
        ffy = fy64 - iy
        # Anchor a fully in-bounds 2x2 block and re-aim each true tap's
        # weight at its slot inside that block; out-of-source taps keep
        # weight 0.  Under src_scale, taps that collapse onto one small
        # pixel accumulate in its slot.
        qy0 = np.clip(iy, 0, sh - 1) // src_scale
        qx0 = np.clip(ix, 0, sw - 1) // src_scale
        base_y = np.clip(qy0, 0, max(qh - 2, 0))
        base_x = np.clip(qx0, 0, max(qw - 2, 0))
        indices = (base_y * qw + base_x).astype(np.int32)
        weights = np.zeros(fx.shape + (4,), np.float32)
        tap_weights = [(iy, ix, (1.0 - ffx) * (1.0 - ffy)),
                       (iy, ix + 1, ffx * (1.0 - ffy)),
                       (iy + 1, ix, (1.0 - ffx) * ffy),
                       (iy + 1, ix + 1, ffx * ffy)]
        for ty, tx, w in tap_weights:
            ok = in_bounds(ty, tx) & window
            qty = np.clip(ty, 0, sh - 1) // src_scale
            qtx = np.clip(tx, 0, sw - 1) // src_scale
            dy = np.clip(qty - base_y, 0, 1)
            dx = np.clip(qtx - base_x, 0, 1)
            slot = (dy * 2 + dx).astype(np.int64)
            w_ok = np.where(ok, w, 0.0).astype(np.float32)
            np.put_along_axis(weights, slot[..., None], np.take_along_axis(
                weights, slot[..., None], axis=2) + w_ok[..., None], axis=2)
    else:
        raise ValueError(f"unknown interpolation {interpolation!r}")

    return indices, weights


def cell_center_taps(matrix: np.ndarray,
                     src_shape: Tuple[int, int],
                     tpl_shape: Tuple[int, int],
                     cells_shape: Tuple[int, int],
                     dst_offset: Tuple[int, int] = (0, 0),
                     valid_rect: Optional[Tuple[int, int, int, int]] = None,
                     interpolation: str = "cv2_linear",
                     src_scale: int = 1) -> WarpTaps:
    """Gather plan sampling ONLY the template pixels the cell binning
    reads (one per cell, ``sx = floor(dx * src/dst)``), with the same
    per-pixel math as :func:`perspective_taps` — the warped cell values
    equal warp-then-resize."""
    sh, sw = src_shape
    th, tw = tpl_shape
    ch, cw = cells_shape
    ty = np.minimum((np.arange(ch) * (th / ch)).astype(np.int64), th - 1)
    tx = np.minimum((np.arange(cw) * (tw / cw)).astype(np.int64), tw - 1)
    ox, oy = dst_offset
    cols = np.broadcast_to(tx[None, :], (ch, cw))
    rows = np.broadcast_to(ty[:, None], (ch, cw))
    xs = cols.astype(np.float32) + np.float32(ox)
    ys = rows.astype(np.float32) + np.float32(oy)
    fx, fy = _inverse_coords_at(matrix, xs, ys)
    window = _window_mask(cols, rows, valid_rect)
    indices, weights = _plan_from_coords(fx, fy, window, src_shape,
                                         interpolation, src_scale)
    return WarpTaps(indices=indices, weights=weights,
                    src_shape=(sh // src_scale, sw // src_scale),
                    mode=interpolation)


def taps_to(taps: WarpTaps, device) -> WarpTaps:
    """The same plan with its arrays as tensors on ``device``."""
    return taps._replace(
        indices=torch.as_tensor(np.asarray(taps.indices),
                                dtype=torch.int64, device=device),
        weights=torch.as_tensor(np.asarray(taps.weights), device=device))


def pack_neighborhood(src: torch.Tensor) -> torch.Tensor:
    """(..., H, W) → (..., H*W, 4): each pixel's [(y,x), (y,x+1), (y+1,x),
    (y+1,x+1)], zero past the right/bottom edge."""
    right = F.pad(src[..., :, 1:], (0, 1))
    down = F.pad(src[..., 1:, :], (0, 0, 0, 1))
    down_right = F.pad(src[..., 1:, 1:], (0, 1, 0, 1))
    packed = torch.stack([src, right, down, down_right], dim=-1)
    return packed.reshape(src.shape[:-2] + (-1, 4))


def apply_warp(src: torch.Tensor, taps: WarpTaps) -> torch.Tensor:
    """Warp (..., H, W) uint8 image(s) through a plan whose arrays are
    tensors on ``src``'s device (:func:`taps_to`).  Returns uint8
    (..., dst_h, dst_w)."""
    idx = taps.indices
    if taps.mode == "nearest":
        flat = src.reshape(src.shape[:-2] + (-1,))
        vals = flat[..., idx]
        return torch.where(taps.weights > 0, vals, torch.zeros_like(vals))
    packed = pack_neighborhood(src).float()
    vals = packed[..., idx, :]                           # (..., h, w, 4)
    wts = taps.weights
    # Sum in tap order, as a sequential reduction over the 4 taps does.
    acc = vals[..., 0] * wts[..., 0]
    for t in range(1, 4):
        acc = acc + vals[..., t] * wts[..., t]
    # cv2 rounds half-to-even and saturates to u8.
    return torch.clamp(torch.round(acc), 0, 255).to(src.dtype)


__all__ = ["cv2_inverse_coords", "perspective_taps", "cell_center_taps",
           "pack_neighborhood", "apply_warp", "taps_to", "WarpTaps"]
