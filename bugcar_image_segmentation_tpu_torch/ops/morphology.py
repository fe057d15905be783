"""Grayscale/binary morphology via shifted-slice min/max chains.

Mirrors ``bugcar_image_segmentation_tpu/ops/morphology.py``: cv2.erode /
dilate / MORPH_OPEN / MORPH_CLOSE with an all-ones rectangular kernel and
OpenCV's default border (the border never constrains the reduction: pad
with the reduction's identity).  Works on (..., H, W) tensors of any dtype.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def _window_reduce(x: torch.Tensor, ksize: Tuple[int, int], op: str
                   ) -> torch.Tensor:
    kh, kw = ksize
    if kh < 1 or kw < 1:
        raise ValueError(f"kernel must be >= 1x1, got {ksize}")
    # cv2's default anchor is k//2; erode and dilate both reduce over
    # src[x - anchor : x + k - anchor).
    ah, aw = kh // 2, kw // 2
    if x.dtype.is_floating_point:
        init = float("inf") if op == "min" else float("-inf")
    else:
        info = torch.iinfo(x.dtype)
        init = info.max if op == "min" else info.min
    combine = torch.minimum if op == "min" else torch.maximum
    h, w = x.shape[-2], x.shape[-1]
    lead = x.shape[:-2]
    # F.pad's constant mode wants at least a 3-D input for 2-D padding
    # on some backends; pad a flattened (B, H, W) view.
    flat = x.reshape((-1, h, w))
    padded = F.pad(flat, (aw, kw - 1 - aw, ah, kh - 1 - ah), value=init)
    out = None
    for dy in range(kh):
        for dx in range(kw):
            v = padded[:, dy:dy + h, dx:dx + w]
            out = v if out is None else combine(out, v)
    return out.reshape(lead + (h, w))


def erode(x: torch.Tensor, ksize: Tuple[int, int] = (3, 3)) -> torch.Tensor:
    """Min-filter; cv2.erode with an all-ones kernel and default border."""
    return _window_reduce(x, ksize, "min")


def dilate(x: torch.Tensor, ksize: Tuple[int, int] = (3, 3)) -> torch.Tensor:
    """Max-filter; cv2.dilate with an all-ones kernel and default border."""
    return _window_reduce(x, ksize, "max")


def morph_open(x: torch.Tensor, ksize: Tuple[int, int] = (3, 3)
               ) -> torch.Tensor:
    """Erosion then dilation (cv2.MORPH_OPEN, reference bev.py:130-131,
    198-199)."""
    return dilate(erode(x, ksize), ksize)


def morph_close(x: torch.Tensor, ksize: Tuple[int, int] = (3, 3)
                ) -> torch.Tensor:
    """Dilation then erosion (cv2.MORPH_CLOSE, reference
    image_processing_utils.py:9)."""
    return erode(dilate(x, ksize), ksize)


__all__ = ["erode", "dilate", "morph_open", "morph_close"]
