"""NHWC building blocks shared by the port's models, as Flax computes them.

- :func:`_same_pads`: XLA's SAME padding of one axis (for a stride-2 conv
  on an even input it pads only the bottom / right, unlike PyTorch's
  symmetric ``padding``);
- :class:`Conv`: ``nn.Conv`` on NHWC tensors (``kernel`` HWIO ↔ ``weight``
  OIHW), with stride, dilation, groups and Flax SAME padding or the
  centred ``k // 2``; it runs on the NCHW view of NHWC memory, so no copy
  is made at its boundaries;
- :class:`BatchNorm`: ``nn.BatchNorm`` over the last axis in f32 from f32
  parameters, cast to the input's dtype: from the running statistics in
  eval mode, from the batch's in train mode (module ``training``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

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
    groups.

    ``rows`` (``parallel/halo.RowShards``, set by spatial partitioning):
    the input is one shard of a frame's rows, and the rows the window
    reads across the shard's edges come from the other ranks."""

    rows = None

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
        if self.rows is not None:
            x = self.rows.conv_rows(x, 1, k, s, d, th)
            h, th, bh = x.shape[1], 0, 0
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
    """``nn.BatchNorm`` over the channel axis (the last; ENet's subclass
    takes axis 1), as Flax computes it.

    Eval mode: ``(x - mean) * (scale * rsqrt(var + eps)) + bias`` from
    the running statistics, cast to the input's dtype.  Both modes compute
    in the wider of the input's dtype and f32, as Flax does (f32 for bf16
    and f32 inputs, f64 for f64 ones).

    Train mode (``self.training``): the same from the batch's statistics,
    taken as Flax takes them (``use_fast_variance``): the biased
    ``var = max(E[x²] - E[x]², 0)``.  Gradients reach ``scale``, ``bias``
    and the input through the statistics.  The forward leaves the running
    statistics alone; it keeps the batch's as :attr:`batch_stats`, and
    :meth:`running_update` gives the new running values, ``m * running +
    (1 - m) * batch`` with Flax's ``momentum`` m (0.99 here; ENet and
    SegFormer take 0.9).  Flax stores the biased variance there too.

    :attr:`sync` (None, or set by a data-parallel train step) sums the
    per-channel sums of x and x² and their count over the ranks, so that
    the statistics are the global batch's.

    A BatchNorm is built in eval mode, so that a model serves unless it
    is switched with ``train()`` (the train state does that).
    """

    channel_dim = -1

    def __init__(self, c: int, eps: float, momentum: float = 0.99):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.sync: Optional[Callable] = None
        self.batch_stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
        self.train(False)

    def _view(self, t: torch.Tensor, ndim: int) -> torch.Tensor:
        shape = [1] * ndim
        shape[self.channel_dim] = -1
        return t.view(shape)

    def forward_train(self, x: torch.Tensor) -> torch.Tensor:
        ct = torch.promote_types(x.dtype, torch.float32)
        xf = x.to(ct)
        c = self.channel_dim % x.dim()
        dims = [d for d in range(x.dim()) if d != c]
        n = x.numel() // x.shape[c]
        moments = torch.stack([xf.sum(dims), (xf * xf).sum(dims)])
        if self.sync is not None:
            moments, n = self.sync(moments, n)
        mean, mean2 = moments / n
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        self.batch_stats = (mean.detach(), var.detach())
        mul = torch.rsqrt(var + self.eps) * self.scale.to(ct)
        y = ((xf - self._view(mean, x.dim())) * self._view(mul, x.dim())
             + self._view(self.bias.to(ct), x.dim()))
        return y.to(x.dtype)

    @torch.no_grad()
    def running_update(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The running (mean, var) after the last train-mode forward."""
        mean, var = self.batch_stats
        m = self.momentum
        return (m * self.mean + (1 - m) * mean, m * self.var + (1 - m) * var)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            return self.forward_train(x)
        ct = torch.promote_types(x.dtype, torch.float32)
        mul = self.scale.to(ct) * torch.rsqrt(self.var.to(ct) + self.eps)
        y = (x.to(ct) - self.mean.to(ct)) * mul + self.bias.to(ct)
        return y.to(x.dtype)


__all__ = ["Conv", "BatchNorm"]
