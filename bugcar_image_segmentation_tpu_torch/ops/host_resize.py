"""Bilinear resize of uint8 camera frames on the host, as cv2 rounds it.

Takes the place of ``cv2.resize(frame, (w, h), interpolation=
cv2.INTER_LINEAR)`` in the JAX package's host-side preparation
(``pipeline.py``, ``Pipeline._prep_host``), in numpy, and gives cv2's
bytes:

- per axis, the source coordinate ``(d + 0.5) * (src / dst) - 0.5`` in
  float32, split into an integer tap and a fraction; along x a coordinate
  before the first or at/after the last pixel is clamped to that pixel
  with fraction 0; along y only the two source rows are clamped;
- weights ``round((1 - f) * 2048)`` and ``round(f * 2048)`` (11
  fractional bits, half to even);
- a horizontal pass in exact integers, ``S = a0 * p0 + a1 * p1``;
- the vertical pass as cv2's vectorised kernel computes it, with 16-bit
  high products: ``((b0 * (S0 >> 4)) >> 16) + ((b1 * (S1 >> 4)) >> 16)``,
  then ``(v + 2) >> 2`` saturated to uint8.  (cv2's scalar form
  ``(b0 * S0 + b1 * S1 + 2**21) >> 22`` differs by 1 on some pixels; cv2
  runs the vector form on every pixel.)

Index and weight plans are cached per (source, destination) size.
"""

from __future__ import annotations

import functools
from typing import Tuple

import numpy as np

COEF_BITS = 11
COEF_SCALE = 1 << COEF_BITS


@functools.lru_cache(maxsize=32)
def _axis(src: int, dst: int, clamp_fraction: bool
          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """(first tap, second tap, first weight, second weight) per output
    index along one axis."""
    scale = 1.0 / (dst / src)
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp_fraction:
        low, high = s < 0, s >= src - 1
        f[low | high] = 0.0
        s[low] = 0
        s[high] = src - 1
    one, scale_w = np.float32(1.0), np.float32(COEF_SCALE)
    w0 = np.rint((one - f) * scale_w).astype(np.int32)
    w1 = np.rint(f * scale_w).astype(np.int32)
    return _frozen(np.clip(s, 0, src - 1), np.clip(s + 1, 0, src - 1), w0, w1)


def _frozen(*arrays: np.ndarray) -> Tuple[np.ndarray, ...]:
    """Read-only: the plans are cached and shared by every caller."""
    for a in arrays:
        a.setflags(write=False)
    return arrays


@functools.lru_cache(maxsize=32)
def _channel_axis(src: int, dst: int, channels: int):
    """:func:`_axis` along x, spread over the interleaved channels of a
    row (index ``x * channels + c``)."""
    x0, x1, a0, a1 = _axis(src, dst, True)
    lanes = np.arange(channels)
    return _frozen((x0[:, None] * channels + lanes).reshape(-1),
                   (x1[:, None] * channels + lanes).reshape(-1),
                   np.repeat(a0, channels), np.repeat(a1, channels))


def resize_linear(frame: np.ndarray, dst_hw: Tuple[int, int]) -> np.ndarray:
    """(H, W[, C]) uint8 → (h, w[, C]) uint8, bit-equal to
    ``cv2.resize(frame, (w, h), interpolation=cv2.INTER_LINEAR)``."""
    frame = np.asarray(frame)
    if frame.dtype != np.uint8 or frame.ndim not in (2, 3):
        raise ValueError(f"need an (H, W[, C]) uint8 image, got "
                         f"{frame.dtype} {frame.shape}")
    h, w = dst_hw
    if h < 1 or w < 1:
        raise ValueError(f"destination size must be positive, got {dst_hw}")
    src = frame if frame.ndim == 3 else frame[..., None]
    sh, sw, c = src.shape
    x0, x1, a0, a1 = _channel_axis(sw, w, c)
    y0, y1, b0, b1 = _axis(sh, h, False)
    rows, inverse = np.unique(np.concatenate([y0, y1]), return_inverse=True)
    part = src.reshape(sh, sw * c)[rows]
    horiz = np.multiply(part[:, x0], a0, dtype=np.int32)
    horiz += np.multiply(part[:, x1], a1, dtype=np.int32)
    horiz >>= 4
    top, bottom = horiz[inverse[:h]], horiz[inverse[h:]]
    top *= b0[:, None]
    bottom *= b1[:, None]
    top >>= 16
    bottom >>= 16
    top += bottom
    top += 2
    top >>= 2           # <= 255: the two weights sum to 2048
    out = top.astype(np.uint8).reshape(h, w, c)
    return out if frame.ndim == 3 else out[..., 0]


__all__ = ["resize_linear"]
