"""DeepLabV3+ over MobileNetV2 in PyTorch, NHWC, and the blocks it shares
with the Xception-65 DeepLab.

Port of ``bugcar_image_segmentation_tpu/models/deeplab.py`` on its
textbook path: ``ConvBN`` (conv → inference BatchNorm, eps 1e-3 → ReLU,
as every Xception site has it, ReLU6 with ``relu6=True``, or nothing),
``ASPP`` (a 1x1 branch, three dilated 3x3 branches, the image-pool branch,
concat, 1x1 merge), ``InvertedResidual`` and ``DeepLabV3`` (the
MobileNetV2 DeepLab, BASELINE config 2's ``deeplab.pb`` model), and
``_upsample`` (``jax.image.resize`` bilinear, the port's JAX-exact
``ops/resize.upsample_bilinear``).

The JAX package's inference lowerings of the same convs are TPU relayouts
of the same sums and are not ported: the stride-2 RGB stem as a 4x4
space-to-depth matmul (``fastconv.S2d4StemConv2x``, always on for the
MobileNetV2 stem at inference) is a plain stride-2 3x3 conv here, ASPP's
dilated branches as nine shifted matmuls (``fastconv.ShiftMatmulConv3x3``)
are dilated convs, and the CHW ``fast_stem`` is not there.  The variable
tree is the same (``Conv_0``, ``BatchNorm_0``); the module tree follows it
(``ir2_0.expand`` ↔ ``params/ir2_0/expand``), so ``convert/flax_deeplab.py``
maps a Flax tree onto it one leaf at a time.

Numerics, as the Flax module: conv weights are used in the activation
dtype (:meth:`DeepLabV3.to_compute_dtype` casts them once), BatchNorm
computes in f32 from f32 parameters, and the final x4 upsample of the
logits runs in f32.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn as nn

from ..ops.resize import upsample_bilinear
from .layers import BatchNorm, Conv

BN_EPS = 1e-3


class ConvBN(nn.Module):
    """Conv (Flax SAME padding, no bias) → BatchNorm → ReLU (every
    Xception site), ReLU6 (``relu6=True``, every MobileNetV2 site) or
    nothing (``act=False``, the MobileNetV2 projection); ``groups`` for the
    depthwise convs."""

    def __init__(self, cin: int, cout: int, kernel: int = 3,
                 stride: int = 1, dilation: int = 1, groups: int = 1,
                 act: bool = True, relu6: bool = False):
        super().__init__()
        self.act, self.relu6 = act, relu6
        self.Conv_0 = Conv(cin, cout, kernel, stride, groups=groups,
                           bias=False, dilation=dilation)
        self.BatchNorm_0 = BatchNorm(cout, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.BatchNorm_0(self.Conv_0(x))
        if not self.act:
            return y
        return y.clamp(0, 6) if self.relu6 else torch.relu(y)


class ASPP(nn.Module):
    """Atrous spatial pyramid pooling: 1x1 + three dilated 3x3 + image
    pool, concatenated and merged by a 1x1 ConvBN."""

    def __init__(self, cin: int, features: int = 256,
                 rates: Sequence[int] = (6, 12, 18), relu6: bool = False):
        super().__init__()
        self.b0 = ConvBN(cin, features, 1, relu6=relu6)
        for i, r in enumerate(rates):
            setattr(self, f"b{i + 1}",
                    ConvBN(cin, features, 3, dilation=r, relu6=relu6))
        self.num_rates = len(rates)
        self.image_pool = ConvBN(cin, features, 1, relu6=relu6)
        self.merge = ConvBN((len(rates) + 2) * features, features, 1,
                            relu6=relu6)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        branches = [getattr(self, f"b{i}")(x)
                    for i in range(self.num_rates + 1)]
        # the mean sums in f32, as jnp.mean does for bf16
        pooled = x.float().mean(dim=(1, 2), keepdim=True).to(x.dtype)
        pooled = self.image_pool(pooled)
        branches.append(pooled.expand(-1, x.shape[1], x.shape[2], -1))
        return self.merge(torch.cat(branches, dim=-1))


class InvertedResidual(nn.Module):
    """MobileNetV2 inverted residual: 1x1 expand (none when ``expand`` is
    1) → depthwise 3x3 (stride, dilation) → 1x1 linear projection, plus the
    input when the stride is 1 and the widths match."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 expand: int = 6, dilation: int = 1):
        super().__init__()
        hidden = cin * expand
        if expand != 1:
            self.expand = ConvBN(cin, hidden, 1, relu6=True)
        self.depthwise = ConvBN(hidden, hidden, 3, stride, dilation,
                                groups=hidden, relu6=True)
        self.project = ConvBN(hidden, features, 1, act=False)
        self.residual = stride == 1 and cin == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.expand(x) if hasattr(self, "expand") else x
        y = self.project(self.depthwise(y))
        return y + x if self.residual else y


# MobileNetV2 at output stride 16: (name, width, stride, expand, dilation)
MNV2_BLOCKS = ([("ir1", 16, 1, 1, 1), ("ir2_0", 24, 2, 6, 1),
                ("ir2_1", 24, 1, 6, 1), ("ir3_0", 32, 2, 6, 1)]
               + [(f"ir3_{i}", 32, 1, 6, 1) for i in (1, 2)]
               + [("ir4_0", 64, 2, 6, 1)]
               + [(f"ir4_{i}", 64, 1, 6, 1) for i in (1, 2, 3)]
               + [(f"ir5_{i}", 96, 1, 6, 1) for i in range(3)]
               + [(f"ir6_{i}", 160, 1, 6, 2) for i in range(3)]
               + [("ir7", 320, 1, 6, 2)])
LOW_LEVEL = "ir2_1"     # the decoder's 1/4-resolution tap


class DeepLabV3(nn.Module):
    """DeepLabV3+ over MobileNetV2 (width 1.0), output stride 16: the stem
    (3x3 stride 2, 32), the inverted residuals of :data:`MNV2_BLOCKS`
    (the last four at dilation 2), ASPP (256 at rates 6 / 12 / 18 + image
    pool) and the decoder (48-channel projection of ``ir2_1``'s 1/4 tap,
    two 3x3 ConvBNs of 256, a 1x1 classifier with bias).  ReLU6
    throughout.

    Input (N, H, W, 3) NHWC with H, W divisible by 16, computed in
    :attr:`dtype`; output float32 logits (N, H, W, classes), or (N, H/4,
    W/4, classes) with ``head_upsample="quarter"``."""

    def __init__(self, num_classes: int = 15, head_upsample: str = "full"):
        super().__init__()
        if head_upsample not in ("full", "quarter"):
            raise ValueError(f"head_upsample must be 'full' or 'quarter', "
                             f"got {head_upsample!r}")
        self.num_classes = num_classes
        self.head_upsample = head_upsample
        self.stem = ConvBN(3, 32, 3, 2, relu6=True)
        cin = 32
        for name, width, stride, expand, dilation in MNV2_BLOCKS:
            setattr(self, name, InvertedResidual(cin, width, stride, expand,
                                                 dilation))
            cin = width
        self.aspp = ASPP(cin, relu6=True)
        self.low_proj = ConvBN(24, 48, 1, relu6=True)
        self.dec0 = ConvBN(256 + 48, 256, 3, relu6=True)
        self.dec1 = ConvBN(256, 256, 3, relu6=True)
        self.classifier = Conv(256, num_classes, 1)

    @property
    def dtype(self) -> torch.dtype:
        return self.stem.Conv_0.weight.dtype

    def to_compute_dtype(self, dtype: torch.dtype) -> "DeepLabV3":
        """Cast the conv weights to ``dtype`` once (Flax casts them at
        every use); BatchNorm stays f32, as Flax computes it."""
        for mod in self.modules():
            if isinstance(mod, Conv):
                mod.to(dtype)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 4 or x.shape[1] % 16 or x.shape[2] % 16:
            raise ValueError(
                f"DeepLabV3 needs NHWC input with H, W divisible by 16 "
                f"(output stride); got {tuple(x.shape)}")
        y = self.stem(x.to(self.dtype))
        for name, *_ in MNV2_BLOCKS:
            y = getattr(self, name)(y)
            if name == LOW_LEVEL:
                low_level = y
        y = self.aspp(y)
        y = _upsample(y, (low_level.shape[1], low_level.shape[2]))
        ll = self.low_proj(low_level)
        y = torch.cat([y, ll.to(y.dtype)], dim=-1)
        y = self.classifier(self.dec1(self.dec0(y))).float()
        if self.head_upsample == "quarter":
            return y
        return _upsample(y, (x.shape[1], x.shape[2]))


def _upsample(x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear upsample of NHWC ``x`` to (h, w), as ``jax.image.resize``
    computes it in ``x``'s dtype."""
    return upsample_bilinear(x, hw, axes=(1, 2))


__all__ = ["ConvBN", "ASPP", "InvertedResidual", "DeepLabV3", "MNV2_BLOCKS",
           "BN_EPS"]
