"""NHWC building blocks shared by the port's models, as Flax computes them.

- :func:`_same_pads`: XLA's SAME padding of one axis (for a stride-2 conv
  on an even input it pads only the bottom / right, unlike PyTorch's
  symmetric ``padding``);
- :class:`Conv`: ``nn.Conv`` on NHWC tensors (``kernel`` HWIO ↔ ``weight``
  OIHW), with stride, dilation, groups and Flax SAME padding or the
  centred ``k // 2``; it runs on the NCHW view of NHWC memory, so no copy
  is made at its boundaries;
- :class:`BatchNorm`: inference ``nn.BatchNorm`` over the last axis in f32
  from f32 parameters, cast to the input's dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F


def _same_pads(size: int, k: int, stride: int, dilation: int
               ) -> Tuple[int, int]:
    """(lo, hi) padding of one axis under XLA's SAME rule."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def _cast(t: Optional[torch.Tensor], like: torch.Tensor
          ) -> Optional[torch.Tensor]:
    return t if t is None or t.dtype == like.dtype else t.to(like.dtype)


class Conv(nn.Module):
    """``nn.Conv`` on NHWC tensors, with Flax SAME padding or the official
    implementation's centred ``k // 2`` ("torch"), stride, dilation and
    groups."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int = 1,
                 groups: int = 1, bias: bool = True, pad: str = "same",
                 dilation: int = 1):
        super().__init__()
        if pad not in ("same", "torch"):
            raise ValueError(f"pad must be 'same' or 'torch', got {pad!r}")
        self.kernel, self.stride, self.groups, self.pad = (kernel, stride,
                                                           groups, pad)
        self.dilation = dilation
        self.weight = nn.Parameter(torch.zeros(cout, cin // groups, kernel,
                                               kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, c = x.shape
        k, s, d = self.kernel, self.stride, self.dilation
        if self.pad == "torch":
            (th, bh), (tw, bw) = ((d * (k // 2),) * 2,) * 2
        else:
            (th, bh), (tw, bw) = (_same_pads(h, k, s, d),
                                  _same_pads(w, k, s, d))
        if (th, tw) == (bh, bw):
            pad = (th, tw)
        else:   # pad in NHWC, so that the conv still reads NHWC memory
            xp = x.new_zeros((n, h + th + bh, w + tw + bw, c))
            xp[:, th:th + h, tw:tw + w] = x
            x, pad = xp, 0
        # NCHW view of NHWC memory (channels_last): cuDNN then writes its
        # output channels_last too, and the NHWC result is contiguous.
        y = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        y = F.conv2d(y, _cast(self.weight, x), _cast(self.bias, x), s, pad,
                     d, self.groups)
        return y.permute(0, 2, 3, 1)


class BatchNorm(nn.Module):
    """Inference ``nn.BatchNorm`` over the last axis, as Flax computes it:
    ``(x - mean) * (scale * rsqrt(var + eps)) + bias`` in f32, cast to the
    input's dtype."""

    def __init__(self, c: int, eps: float):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mul = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
        y = (x.float() - self.mean.float()) * mul + self.bias.float()
        return y.to(x.dtype)


__all__ = ["Conv", "BatchNorm"]
