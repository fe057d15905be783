"""DeepLabV3+'s shared blocks in PyTorch, NHWC.

Port of the blocks of ``bugcar_image_segmentation_tpu/models/deeplab.py``
that the Xception-65 DeepLab uses, on their textbook path: ``ConvBN``
(conv → inference BatchNorm, eps 1e-3 → ReLU; ``relu6=False``, as every
Xception site has it), ``ASPP`` (a 1x1 branch, three dilated 3x3 branches,
the image-pool branch, concat, 1x1 merge) and ``_upsample``
(``jax.image.resize`` bilinear, the port's JAX-exact
``ops/resize.upsample_bilinear``).

The JAX package's inference lowerings of the same convs are not ported:
its stride-2 RGB stem as a 4x4 space-to-depth matmul
(``fastconv.S2d4StemConv2x``) is a plain stride-2 3x3 conv here, and
ASPP's dilated branches as nine shifted matmuls
(``fastconv.ShiftMatmulConv3x3``) are dilated convs.  The variable tree
is the same (``Conv_0``, ``BatchNorm_0``).
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.resize import upsample_bilinear
from .layers import BatchNorm, Conv

BN_EPS = 1e-3


class ConvBN(nn.Module):
    """Conv (Flax SAME padding, no bias) → BatchNorm → ReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, bias=False,
                           dilation=dilation)
        self.BatchNorm_0 = BatchNorm(cout, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.BatchNorm_0(self.Conv_0(x)))


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1 + three dilated 3x3 + image
    pool, concatenated and merged by a 1x1 ConvBN."""

    def __init__(self, cin: int, features: int = 256,
                 rates: Sequence[int] = (6, 12, 18)):
        super().__init__()
        self.b0 = ConvBN(cin, features, 1)
        for i, r in enumerate(rates):
            setattr(self, f"b{i + 1}", ConvBN(cin, features, 3, dilation=r))
        self.num_rates = len(rates)
        self.image_pool = ConvBN(cin, features, 1)
        self.merge = ConvBN((len(rates) + 2) * features, features, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"b{i}")(x)
                    for i in range(self.num_rates + 1)]
        # the mean sums in f32, as jnp.mean does for bf16
        pooled = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        pooled = self.image_pool(pooled)
        branches.append(pooled.expand(-1, x.shape[1], x.shape[2], -1))
        return self.merge(torch.cat(branches, dim=-1))


def _upsample(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample of NHWC ``x`` to (h, w), as ``jax.image.resize``
    computes it in ``x``'s dtype."""
    return upsample_bilinear(x, hw, axes=(1, 2))


__all__ = ["ConvBN", "ASPP", "BN_EPS"]
