"""Image resizing with cv2 coordinate conventions, as index gathers.

Mirrors ``bugcar_image_segmentation_tpu/ops/resize.py`` with the same
index/weight arithmetic, so results agree with the JAX package value for
value (``F.interpolate`` rounds its source coordinates differently):

- ``resize_nearest``: INTER_NEAREST with cv2's ``sx = floor(dx * src/dst)``
  (reference bev.py:139-141, 209-212 — the template→cell binning step).
- ``resize_bilinear``: half-pixel-centre bilinear with replicated edges
  (reference models.py:87, 129 — camera frame → model input).
- ``upsample_nearest_int``: integer-factor pixel replication.

Index plans are computed on the host once per (src, dst) shape pair and
cached per device.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=64)
def _nearest_indices(src: int, dst: int) -> np.ndarray:
    scale = src / dst
    idx = np.minimum((np.arange(dst) * scale).astype(np.int64), src - 1)
    return idx


@functools.lru_cache(maxsize=64)
def _linear_axis(src: int, dst: int):
    x = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = (x - x0).astype(np.float32)
    i0 = np.clip(x0, 0, src - 1)
    i1 = np.clip(x0 + 1, 0, src - 1)
    return i0, i1, frac


@functools.lru_cache(maxsize=128)
def _on_device(kind: str, src: int, dst: int, device: torch.device):
    if kind == "nearest":
        return torch.as_tensor(_nearest_indices(src, dst), device=device)
    i0, i1, frac = _linear_axis(src, dst)
    return (torch.as_tensor(i0, device=device),
            torch.as_tensor(i1, device=device),
            torch.as_tensor(frac, device=device))


def resize_nearest(img: torch.Tensor, dst_hw: Tuple[int, int]) -> torch.Tensor:
    """cv2.resize(..., INTER_NEAREST) over the trailing (H, W) axes."""
    dh, dw = dst_hw
    sh, sw = img.shape[-2], img.shape[-1]
    ys = _on_device("nearest", sh, dh, img.device)
    xs = _on_device("nearest", sw, dw, img.device)
    return img.index_select(-2, ys).index_select(-1, xs)


def resize_bilinear(img: torch.Tensor, dst_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """Half-pixel-centre bilinear resize of the trailing (H, W) axes, f32."""
    dh, dw = dst_hw
    sh, sw = img.shape[-2], img.shape[-1]
    iy0, iy1, fy = _on_device("linear", sh, dh, img.device)
    ix0, ix1, fx = _on_device("linear", sw, dw, img.device)
    fy = fy[:, None]
    x = img.float()
    top = x.index_select(-2, iy0)
    bot = x.index_select(-2, iy1)
    row = top * (1.0 - fy) + bot * fy
    left = row.index_select(-1, ix0)
    right = row.index_select(-1, ix1)
    return left * (1.0 - fx) + right * fx


def upsample_nearest_int(x: torch.Tensor, factor: int) -> torch.Tensor:
    """Integer-factor nearest upsample of the trailing (H, W) axes by
    exact pixel replication (bit-identical to INTER_NEAREST)."""
    if factor < 1:
        raise ValueError(f"factor must be >= 1, got {factor}")
    if factor == 1:
        return x
    h, w = x.shape[-2], x.shape[-1]
    y = x[..., :, None, :, None].expand(x.shape[:-2] + (h, factor, w, factor))
    return y.reshape(x.shape[:-2] + (h * factor, w * factor))


__all__ = ["resize_nearest", "resize_bilinear", "upsample_nearest_int"]
