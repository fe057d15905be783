"""Post-segmentation cleanup and camera pre-enhancement, on the device.

Port of ``bugcar_image_segmentation_tpu/postproc.py``, the rebuilds of the
two host/OpenCV passes the reference ran per frame (reference
image_processing_utils.py):

- :func:`contour_noise_removal` (reference :4-44): keep only road regions
  connected to the vehicle's footwell: morph-close, fill holes, then
  connected components by min-label propagation to a fixed point and a
  per-component count of bottom-strip overlap.  Components are
  pixel-connected regions, not filled polygons (the JAX package's one
  documented deviation from the reference).
- :func:`clahe` (reference :46-61): CLAHE on the L channel of LAB (clip
  3.0, 8x8 tiles): per-tile 256-bin histograms, clip and redistribute,
  CDF LUTs, bilinearly interpolated LUT application -- cv2's algorithm in
  float, as the JAX package computes it.

The fixed points are Python loops over torch ops: each propagation step
is monotone (labels only fall, the reached set only grows), so the loop
checks for a fixed point every :data:`CHECK_EVERY` steps, one host sync a
check, and the number of steps past the fixed point does not change the
result.  Every function takes leading batch axes, each frame's result the
one it gets alone.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from .ops import morphology

# Reference constants (image_processing_utils.py:19-21).
LENGTH_RATIO = 0.1
MASK_AREA_THRESH = 0.4
CHECK_EVERY = 8      # propagation steps between fixed-point checks


def _fixed_point(step, state: torch.Tensor) -> torch.Tensor:
    """Apply ``step`` until ``state`` stops changing."""
    while True:
        before = state
        for _ in range(CHECK_EVERY):
            state = step(state)
        if torch.equal(state, before):
            return state


def label_components(mask: torch.Tensor) -> torch.Tensor:
    """8-connected component labels of a {0,1} mask (..., H, W), int64:
    each foreground pixel gets the minimum flat index of its component
    plus 1, background 0.  Foreground is 8-connected (background
    4-connected), matching cv2's contour topology.

    The propagation runs on negated labels in f32 (exact up to 2^24
    pixels a frame) so that a 3x3 max pool is the window minimum."""
    h, w = mask.shape[-2:]
    if h * w + 1 >= 2 ** 24:
        raise ValueError(f"label_components takes at most 2^24 - 2 pixels "
                         f"a frame, got {h}x{w}")
    lead = mask.shape[:-2]
    fg = (mask > 0).reshape(-1, 1, h, w)
    big = float(h * w + 1)
    idx = torch.arange(1, h * w + 1, device=mask.device,
                       dtype=torch.float32).reshape(1, 1, h, w)
    neg = torch.where(fg, -idx, -big)

    def step(n: torch.Tensor) -> torch.Tensor:
        return torch.where(fg, F.max_pool2d(n, 3, 1, 1), -big)

    labels = (-_fixed_point(step, neg)).to(torch.int64)
    return torch.where(fg, labels, 0).reshape(*lead, h, w)


def fill_holes(mask: torch.Tensor) -> torch.Tensor:
    """Fill the interior holes of a {0,1} mask (..., H, W): background
    4-connected to the image border stays, enclosed background becomes
    foreground -- the pixel equivalent of ``cv2.fillPoly`` over outer
    contours (reference image_processing_utils.py:34-35, 41-42)."""
    h, w = mask.shape[-2:]
    bg = (mask == 0).reshape(-1, 1, h, w)
    border = torch.ones(h, w, dtype=torch.bool, device=mask.device)
    border[1:-1, 1:-1] = False
    cross = torch.tensor([[0., 1., 0.], [1., 1., 1.], [0., 1., 0.]],
                         device=mask.device).reshape(1, 1, 3, 3)

    def step(reach: torch.Tensor) -> torch.Tensor:
        return (F.conv2d(reach, cross, padding=1) > 0) & bg

    reach = _fixed_point(lambda r: step(r.float()),
                         (border & bg).float()).reshape(mask.shape)
    return ((mask != 0) | ((mask == 0) & ~reach)).to(mask.dtype)


def keep_components_by_strip_overlap(mask: torch.Tensor,
                                     strip_ratio: float = LENGTH_RATIO,
                                     area_thresh: float = MASK_AREA_THRESH,
                                     ) -> torch.Tensor:
    """Keep the components of a {0,1} mask (..., H, W) whose overlap with
    the bottom ``strip_ratio`` of the frame exceeds ``area_thresh`` of the
    strip's area (reference image_processing_utils.py:19-39)."""
    h, w = mask.shape[-2:]
    strip_h = int(h * strip_ratio)
    labels = label_components(mask).reshape(-1, h * w)
    rows = torch.arange(h, device=mask.device).repeat_interleave(w)
    in_strip = (rows >= h - strip_h) & (labels > 0)
    overlap = torch.zeros(labels.shape[0], h * w + 1, dtype=torch.int64,
                          device=mask.device)
    overlap.scatter_add_(1, torch.where(in_strip, labels, 0),
                         torch.ones_like(labels))
    overlap[:, 0] = 0
    keep = overlap > int(area_thresh * (strip_h * w))
    kept = keep.gather(1, labels) & (labels > 0)
    return kept.to(mask.dtype).reshape(mask.shape)


def contour_noise_removal(road_mask: torch.Tensor,
                          strip_ratio: float = LENGTH_RATIO,
                          area_thresh: float = MASK_AREA_THRESH,
                          ) -> torch.Tensor:
    """Reference image_processing_utils.py:4-44 on a {0,1} uint8 road
    mask (..., H, W): morph-close with kernel ``min(H, W) // 50`` to
    bridge small gaps, fill holes, then drop every region not connected
    enough to the bottom strip."""
    h, w = road_mask.shape[-2:]
    k = max(1, min(h, w) // 50)
    closed = morphology.morph_close(road_mask.to(torch.uint8), (k, k))
    return keep_components_by_strip_overlap(fill_holes(closed), strip_ratio,
                                            area_thresh)


def bgr_to_lab_l(bgr: torch.Tensor) -> torch.Tensor:
    """L channel of CIELAB from uint8 BGR (..., H, W, 3), cv2's 8-bit
    scaling (L*255/100), f32: sRGB → linear → Y (D65) → L*."""
    rgb = bgr.flip(-1).float() / 255.0
    lin = torch.where(rgb > 0.04045, ((rgb + 0.055) / 1.055) ** 2.4,
                      rgb / 12.92)
    y = (0.212671 * lin[..., 0] + 0.715160 * lin[..., 1]
         + 0.072169 * lin[..., 2])
    fy = torch.where(y > 0.008856, y.pow(1.0 / 3.0),
                     7.787 * y + 16.0 / 116.0)
    l_star = 116.0 * fy - 16.0
    return l_star * (255.0 / 100.0)


def _tile_luts(l_u8: torch.Tensor, tiles: Tuple[int, int],
               clip_limit: float) -> torch.Tensor:
    """(B, ty, tx, 256) f32 LUTs of (B, H, W) uint8: per-tile
    clipped-histogram CDFs scaled to [0, 255] and rounded."""
    b, h, w = l_u8.shape
    ty, tx = tiles
    th, tw = h // ty, w // tx
    tile_pix = th * tw
    t = l_u8[:, :ty * th, :tx * tw].reshape(b, ty, th, tx, tw)
    t = t.permute(0, 1, 3, 2, 4).reshape(b, ty * tx, tile_pix)
    bins = (torch.arange(ty * tx, device=l_u8.device)[:, None] * 256
            + t.long()).reshape(b, -1)
    hist = torch.zeros(b, ty * tx * 256, device=l_u8.device)
    hist.scatter_add_(1, bins, torch.ones_like(bins, dtype=torch.float32))
    hist = hist.reshape(b, ty * tx, 256)
    # cv2's clip limit scales with the tile size (clipLimit * tilePix / 256)
    limit = max(1.0, clip_limit * tile_pix / 256.0)
    clipped = hist.clamp(max=limit)
    excess = (hist - clipped).sum(-1, keepdim=True)
    cdf = torch.cumsum(clipped + excess / 256.0, -1)
    luts = torch.round(cdf * (255.0 / tile_pix)).clamp(0, 255)
    return luts.reshape(b, ty, tx, 256)


def clahe_l_channel(l_u8: torch.Tensor, clip_limit: float = 3.0,
                    tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """CLAHE on uint8 channel(s) (..., H, W), cv2.createCLAHE's semantics
    in float: each pixel interpolates bilinearly the LUTs of the four
    surrounding tile centres."""
    h, w = l_u8.shape[-2:]
    flat = l_u8.reshape(-1, h, w)
    ty, tx = tiles
    th, tw = h // ty, w // tx
    luts = _tile_luts(flat, tiles, clip_limit)
    dev = l_u8.device

    def axis(n, t, tiles_n):
        # XLA divides by a constant as it multiplies by the constant's f32
        # reciprocal; so does this, for the same tile coordinates
        c = (torch.arange(n, dtype=torch.float32, device=dev) + 0.5) * (
            1.0 / t) - 0.5
        i0 = torch.floor(c).clamp(0, tiles_n - 1).long()
        return i0, (i0 + 1).clamp(0, tiles_n - 1), (c - i0).clamp(0.0, 1.0)

    y0, y1, fy = axis(h, th, ty)
    x0, x1, fx = axis(w, tw, tx)
    fy, fx = fy[:, None], fx[None, :]
    v = flat.long()
    bi = torch.arange(flat.shape[0], device=dev)[:, None, None]

    def look(tyi, txi):
        return luts[bi, tyi[None, :, None], txi[None, None, :], v]

    out = ((1 - fy) * (1 - fx) * look(y0, x0)
           + (1 - fy) * fx * look(y0, x1)
           + fy * (1 - fx) * look(y1, x0)
           + fy * fx * look(y1, x1))
    return torch.round(out).clamp(0, 255).to(torch.uint8).reshape(
        l_u8.shape)


def clahe(bgr: torch.Tensor, clip_limit: float = 3.0,
          tiles: Tuple[int, int] = (8, 8)) -> torch.Tensor:
    """Contrast-limited adaptive histogram equalization of uint8 BGR
    frame(s) (..., H, W, 3) (reference image_processing_utils.py:46-61):
    L of LAB equalized, and the equalized/original L ratio (+1 each)
    rescales the BGR values, as the JAX package does it."""
    l_orig = torch.round(bgr_to_lab_l(bgr)).clamp(0, 255).to(torch.uint8)
    l_eq = clahe_l_channel(l_orig, clip_limit, tiles)
    ratio = (l_eq.float() + 1.0) / (l_orig.float() + 1.0)
    out = bgr.float() * ratio[..., None]
    return torch.round(out).clamp(0, 255).to(torch.uint8)


__all__ = [
    "contour_noise_removal", "keep_components_by_strip_overlap",
    "label_components", "fill_holes", "clahe", "clahe_l_channel",
    "bgr_to_lab_l", "LENGTH_RATIO", "MASK_AREA_THRESH", "CHECK_EVERY",
]
