"""Pooling primitives over NHWC tensors.

Mirrors ``bugcar_image_segmentation_tpu/ops/pooling.py`` (2x2/2 max pool)
and the ENet pool helpers of ``models/enet.py:41-77`` (pool with
window-argmax indices, and the matching unpool).  The window index is
computed with ``argmax`` over an explicit 4-slot axis, so the FIRST
maximum wins, as TF's ``max_pool_with_argmax`` and the JAX package do;
``max_pool2d(return_indices=True)`` promises no tie rule.
"""

from __future__ import annotations

from typing import Tuple

import torch


def _windows(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) → (..., H/2, W/2, 4, C), window slots row-major."""
    *lead, h, w, c = x.shape
    y = x.reshape(-1, h // 2, 2, w // 2, 2, c)
    y = y.permute(0, 1, 3, 2, 4, 5).reshape(-1, h // 2, w // 2, 4, c)
    return y, tuple(lead)


def max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2x2/stride-2 max pool over (..., H, W, C), H and W even."""
    y, lead = _windows(x)
    return y.amax(dim=-2).reshape(lead + y.shape[1:3] + (x.shape[-1],))


def max_pool_with_indices(x: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(N, H, W, C) → (pooled, uint8 window index in {0, 1, 2, 3})."""
    y, _ = _windows(x)
    idx = torch.argmax(y, dim=3).to(torch.uint8)
    pooled = y.amax(dim=3)
    return pooled, idx


def max_unpool(pooled: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`max_pool_with_indices`: each pooled value goes to
    its remembered window slot, zeros elsewhere.  (N, h, w, C) → (N, 2h,
    2w, C)."""
    n, hh, ww, c = pooled.shape
    zero = torch.zeros((), dtype=pooled.dtype, device=pooled.device)
    slots = [torch.where(idx == p, pooled, zero) for p in range(4)]
    y = torch.stack(slots, dim=3).reshape(n, hh, ww, 2, 2, c)
    return y.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * hh, 2 * ww, c)


__all__ = ["max_pool_2x2", "max_pool_with_indices", "max_unpool"]
