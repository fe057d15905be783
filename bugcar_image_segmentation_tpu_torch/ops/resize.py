"""Image resizing with cv2 coordinate conventions, as index gathers.

Mirrors ``bugcar_image_segmentation_tpu/ops/resize.py`` with the same
index/weight arithmetic, so results agree with the JAX package value for
value (``F.interpolate`` rounds its source coordinates differently):

- ``resize_nearest``: INTER_NEAREST with cv2's ``sx = floor(dx * src/dst)``
  (reference bev.py:139-141, 209-212 — the template→cell binning step).
- ``resize_bilinear``: half-pixel-centre bilinear with replicated edges
  (reference models.py:87, 129 — camera frame → model input).
- ``upsample_bilinear``: ``jax.image.resize(method="bilinear")`` for
  upsampling (the SegFormer head), rounding where JAX rounds.
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


def _lerp_axis(x: torch.Tensor, dim: int, dst: int) -> torch.Tensor:
    """Half-pixel-centre bilinear resampling of one axis, in f32."""
    i0, i1, frac = _on_device("linear", x.shape[dim], dst, x.device)
    shape = [1] * x.dim()
    shape[dim] = dst
    frac = frac.view(shape)
    lo = x.index_select(dim, i0).float()
    hi = x.index_select(dim, i1).float()
    return lo * (1.0 - frac) + hi * frac


def resize_bilinear(img: torch.Tensor, dst_hw: Tuple[int, int]
                    ) -> torch.Tensor:
    """Half-pixel-centre bilinear resize of the trailing (H, W) axes, f32."""
    return _lerp_axis(_lerp_axis(img, -2, dst_hw[0]), -1, dst_hw[1])


def upsample_bilinear(x: torch.Tensor, dst_hw: Tuple[int, int],
                      axes: Tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """``jax.image.resize(..., method="bilinear")`` of the ``axes`` (H, W)
    to a size no smaller, value for value.

    Upsampling needs no antialiasing, and the edge renormalisation of
    JAX's weights reduces to clamping the source index, so each axis is
    :func:`resize_bilinear`'s lerp.  JAX contracts one axis at a time in
    the input's dtype (an einsum over two weight matrices, in the order
    of fewer multiplications, H first on a tie), so the result is rounded
    to ``x.dtype`` after each axis in that order; in float32 that is
    ``resize_bilinear`` up to the last bit.
    """
    ah, aw = (a % x.dim() for a in axes)
    (sh, sw), (dh, dw) = (x.shape[ah], x.shape[aw]), dst_hw
    if dh < sh or dw < sw:
        raise ValueError(f"upsample_bilinear: {(sh, sw)} -> {(dh, dw)} "
                         f"shrinks an axis")
    h_first = dh * sh * sw + dh * dw * sw <= sh * dw * sw + dh * dw * sh
    for dim, dst in (((ah, dh), (aw, dw)) if h_first
                     else ((aw, dw), (ah, dh))):
        if x.shape[dim] != dst:
            x = _lerp_axis(x, dim, dst).to(x.dtype)
    return x


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


__all__ = ["resize_nearest", "resize_bilinear", "upsample_bilinear",
           "upsample_nearest_int"]
