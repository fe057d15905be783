"""I420 (YUV 4:2:0) frame transport: half the host→device bytes of BGR.

Port of ``bugcar_image_segmentation_tpu/ops/yuv.py``.  The host packs
cv2's I420 layout — a (3H/2, W) uint8 buffer: the full-resolution Y
plane, then the 2x2-subsampled U and V planes, each flattened row-major
into H/4 rows of W — and the device converts it back to BGR inside the
frame→grid program.

- :func:`bgr_to_i420_host` is ``cv2.cvtColor(frame, COLOR_BGR2YUV_I420)``
  in numpy, bit for bit: cv2's BT.601 video-range fixed point (20
  fractional bits, round half up), chroma taken from the top-left pixel
  of each 2x2 block (not their mean).
- :func:`i420_to_bgr` is the JAX package's device conversion in torch ops
  with the same f32 constants in the same order, so it gives the JAX
  function's bytes (within ±1 of cv2's ``COLOR_YUV2BGR_I420``).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .resize import upsample_nearest_int

# cv2's BGR→YUV coefficients, scaled by 2**20 (color_yuv.simd.hpp).
_SHIFT = 20
_HALF = 1 << (_SHIFT - 1)
_Y = (269484, 528482, 102760)        # R, G, B
_U = (-155188, -305135, 460324)
_V = (460324, -385875, -74448)


def i420_shape(frame_hw: Tuple[int, int]) -> Tuple[int, int]:
    """(H, W) → the packed I420 buffer shape (3H/2, W)."""
    h, w = frame_hw
    if h % 2 or w % 2:
        raise ValueError(f"I420 needs even H, W; got {(h, w)}")
    return (h * 3 // 2, w)


def _plane(r, g, b, coef, offset: int) -> np.ndarray:
    cr, cg, cb = coef
    v = cr * r + cg * g + cb * b + ((offset << _SHIFT) + _HALF)
    return (v >> _SHIFT).astype(np.uint8)


def bgr_to_i420_host(frame_bgr: np.ndarray) -> np.ndarray:
    """(H, W, 3) uint8 BGR → (3H/2, W) uint8 I420, as cv2 packs it."""
    frame = np.asarray(frame_bgr)
    if frame.dtype != np.uint8 or frame.ndim != 3 or frame.shape[2] != 3:
        raise ValueError(f"need an (H, W, 3) uint8 BGR frame, got "
                         f"{frame.dtype} {frame.shape}")
    h, w = frame.shape[:2]
    out_shape = i420_shape((h, w))
    b, g, r = (frame[..., i].astype(np.int32) for i in range(3))
    sub = (slice(0, None, 2), slice(0, None, 2))
    out = np.empty(out_shape, np.uint8)
    flat = out.reshape(-1)
    n_y, n_c = h * w, (h // 2) * (w // 2)
    flat[:n_y] = _plane(r, g, b, _Y, 16).reshape(-1)
    flat[n_y:n_y + n_c] = _plane(r[sub], g[sub], b[sub], _U, 128).reshape(-1)
    flat[n_y + n_c:] = _plane(r[sub], g[sub], b[sub], _V, 128).reshape(-1)
    return out


def i420_to_bgr(packed: torch.Tensor, frame_hw: Tuple[int, int]
                ) -> torch.Tensor:
    """(..., 3H/2, W) uint8 I420 → (..., H, W, 3) uint8 BGR, on the
    tensor's device; BT.601 video-range inverse with the JAX package's
    constants (round half to even, as ``jnp.round``)."""
    h, w = frame_hw
    lead = tuple(packed.shape[:-2])
    y = packed[..., :h, :].float()
    u = packed[..., h:h * 5 // 4, :].reshape(lead + (h // 2, w // 2)).float()
    v = packed[..., h * 5 // 4:, :].reshape(lead + (h // 2, w // 2)).float()
    uu = upsample_nearest_int(u, 2) - 128.0
    vv = upsample_nearest_int(v, 2) - 128.0
    yy = 1.164 * (y - 16.0)
    r = yy + 1.596 * vv
    g = yy - 0.813 * vv - 0.391 * uu
    b = yy + 2.018 * uu
    bgr = torch.stack([b, g, r], dim=-1)
    return torch.clamp(torch.round(bgr), 0, 255).to(torch.uint8)


__all__ = ["i420_shape", "bgr_to_i420_host", "i420_to_bgr"]
