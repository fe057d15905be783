"""ENet semantic-segmentation backbone in PyTorch.

Port of ``bugcar_image_segmentation_tpu/models/enet.py`` (``ENet``, its
textbook path: ``fast=False``), the capability of the reference's frozen
``enet.pb`` (reference models.py:14-95: 512x256 input, 15 classes):
initial block, three bottleneck stages with dilated/asymmetric
convolutions, max-unpooling decoder, a 3x3 stride-2 transposed-conv head.

The module tree and parameter names follow the Flax variable tree
(``initial.Conv_0.weight`` ↔ ``params/initial/Conv_0/kernel``, BatchNorm
running statistics as buffers), so ``convert/flax_enet.py`` maps a Flax
checkpoint onto it one leaf at a time.  Conv weights are OIHW; the
transposed convs keep PyTorch's ``conv_transpose2d`` layout (in, out, kh,
kw), spatially flipped relative to Flax's kernel.

The public ``forward`` takes and returns NHWC, as the JAX package's model
does; inside, tensors are NCHW views.  Flax's SAME padding is applied
explicitly (for a stride-2 conv on an even input it pads only the bottom
and right, unlike ``padding=1``).  BatchNorm runs from constants folded in
f32 (``mul``, ``add`` buffers, refreshed when a state dict is loaded), so
casting the module to bfloat16 afterwards keeps the f32 fold.
:meth:`ENet.round_weights_bf16` serves from bf16-rounded weights
(``_w16``) and refolds as the JAX engine folds bf16 leaves.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import max_pool_with_indices, max_unpool
from .layers import _cast, _same_pads

BN_EPS = 1e-3


class Conv(nn.Module):
    """``nn.Conv`` with Flax SAME padding (``kernel`` ↔ ``weight``)."""

    def __init__(self, cin: int, cout: int, kernel: Tuple[int, int] = (3, 3),
                 stride: int = 1, dilation: int = 1, bias: bool = False):
        super().__init__()
        self.kernel, self.stride, self.dilation = kernel, stride, dilation
        self.weight = nn.Parameter(torch.empty(cout, cin, *kernel))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        (th, bh), (tw, bw) = (
            _same_pads(x.shape[2], self.kernel[0], self.stride,
                       self.dilation),
            _same_pads(x.shape[3], self.kernel[1], self.stride,
                       self.dilation))
        if (th, tw) == (bh, bw):
            pad = (th, tw)
        else:
            x = F.pad(x, (tw, bw, th, bh))
            pad = 0
        return F.conv2d(x, _cast(self.weight, x), _cast(self.bias, x),
                        self.stride, pad, self.dilation)


class ConvTranspose(nn.Module):
    """``nn.ConvTranspose(features, (3, 3), strides=(2, 2),
    padding="SAME")``: (N, C, H, W) → (N, C', 2H, 2W).

    Flax runs it as a stride-1 conv of the unflipped kernel over the
    2x-dilated input padded (2, 1); that is ``conv_transpose2d`` with the
    kernel flipped (the stored layout) and the last row and column of its
    (2H+1, 2W+1) output dropped."""

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        y = F.conv_transpose2d(x, _cast(self.weight, x), _cast(self.bias, x),
                               stride=2)
        return y[:, :, :2 * h, :2 * w]


class BatchNorm(nn.Module):
    """Inference BatchNorm (eps 1e-3) with Flax's variable names."""

    def __init__(self, c: int, eps: float = BN_EPS):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))
        self.register_buffer("mul", torch.ones(c), persistent=False)
        self.register_buffer("add", torch.zeros(c), persistent=False)
        self.folded_bf16 = False
        self.fold()

    @torch.no_grad()
    def fold(self) -> None:
        """Refresh the folded constants from the parameters, in f32."""
        mul = self.scale.float() * torch.rsqrt(self.var.float() + self.eps)
        add = self.bias.float() - self.mean.float() * mul
        self.mul.copy_(mul)
        self.add.copy_(add)
        self.folded_bf16 = False

    @torch.no_grad()
    def fold_bf16(self, round_shift: bool) -> None:
        """Refresh the folded constants from parameters that hold bfloat16
        values (``_w16``), rounding where the JAX engine rounds when it
        folds bf16 leaves on the CPU (XLA keeps the last product of each
        chain in f32): ``rs = bf16(rsqrt(bf16(var + eps)))``, ``mul =
        scale·rs``; ``add = bias − bf16(bf16(mean·scale)·rs)`` with
        ``round_shift`` (the JAX package's ``PhaseBatchNorm`` and
        ``ChwBatchNorm``, its models/enet.py:133-136 and :201-204), else
        ``bias − mean·mul`` (Flax's BatchNorm, which applies ``(x −
        mean)·mul + bias``)."""
        def bf(t):
            return t.float().to(torch.bfloat16).float()

        scale, bias, mean = bf(self.scale), bf(self.bias), bf(self.mean)
        rs = bf(torch.rsqrt(bf(bf(self.var) + self.eps)))
        mul = scale * rs
        add = (bias - bf(bf(mean * scale) * rs) if round_shift
               else bias - mean * mul)
        self.mul.copy_(mul)
        self.add.copy_(add)
        self.folded_bf16 = True

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self.fold()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return (x * _cast(self.mul, x)[:, None, None]
                + _cast(self.add, x)[:, None, None])


class PReLU(nn.Module):
    """Per-channel parametric ReLU (``alpha``, initialised 0.25)."""

    def __init__(self, c: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((c,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, _cast(self.alpha, x)[:, None, None] * x)


class ConvBNAct(nn.Module):
    """Conv → BatchNorm → PReLU/none (``Conv_0``, ``BatchNorm_0``,
    ``PReLU_0``), the repeated ENet motif."""

    def __init__(self, cin: int, cout: int, kernel=(3, 3), stride: int = 1,
                 dilation: int = 1, act: bool = True):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, dilation)
        self.BatchNorm_0 = BatchNorm(cout)
        self.PReLU_0 = PReLU(cout) if act else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.BatchNorm_0(self.Conv_0(x))
        return x if self.PReLU_0 is None else self.PReLU_0(x)


class InitialBlock(nn.Module):
    """ENet stem: 3x3/2 conv (13 ch) concatenated with a 2x2 max pool."""

    def __init__(self, cin: int = 3):
        super().__init__()
        self.Conv_0 = Conv(cin, 16 - cin, (3, 3), stride=2)
        self.BatchNorm_0 = BatchNorm(16)
        self.PReLU_0 = PReLU(16)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = torch.cat([self.Conv_0(x), F.max_pool2d(x, 2)], dim=1)
        return self.PReLU_0(self.BatchNorm_0(out))


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


class Bottleneck(nn.Module):
    """The ENet bottleneck: kind "regular" | "dilated" | "asymmetric" |
    "down" | "up".

    Main branch: 1x1 (2x2/2 when downsampling) projection → core conv
    (3x3, dilated 3x3, 5x1 then 1x5, or 3x3 transposed) → 1x1 expansion.
    Skip branch: identity / pool-with-indices + channel zero-pad / 1x1
    conv + unpool.  Sum, then PReLU.  ``forward`` takes NCHW and returns
    (y, pool indices or None); the indices are NHWC uint8.
    """

    def __init__(self, cin: int, features: int, kind: str = "regular",
                 dilation: int = 1, projection_ratio: int = 4):
        super().__init__()
        if kind not in ("regular", "dilated", "asymmetric", "down", "up"):
            raise ValueError(f"unknown bottleneck kind {kind!r}")
        self.kind, self.dilation, self.features = kind, dilation, features
        mid = features // projection_ratio
        if kind == "down":
            self.proj = ConvBNAct(cin, mid, (2, 2), stride=2)
        else:
            self.proj = ConvBNAct(cin, mid, (1, 1))
        if kind == "asymmetric":
            self.conv_5x1 = Conv(mid, mid, (5, 1))
            self.conv_1x5 = ConvBNAct(mid, mid, (1, 5))
        elif kind == "up":
            self.deconv = ConvTranspose(mid, mid)
            self.deconv_bn = BatchNorm(mid)
            self.deconv_act = PReLU(mid)
        else:
            self.conv = ConvBNAct(mid, mid, (3, 3), dilation=dilation)
        self.expand = ConvBNAct(mid, features, (1, 1), act=False)
        if kind == "up":
            self.skip_proj = ConvBNAct(cin, features, (1, 1), act=False)
        self.out_act = PReLU(features)

    def forward(self, x: torch.Tensor,
                pool_idx: Optional[torch.Tensor] = None,
                ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        new_idx = None
        y = self.proj(x)
        if self.kind == "asymmetric":
            y = self.conv_1x5(self.conv_5x1(y))
        elif self.kind == "up":
            y = self.deconv_act(self.deconv_bn(self.deconv(y)))
        else:
            y = self.conv(y)
        y = self.expand(y)

        if self.kind == "down":
            pooled, new_idx = max_pool_with_indices(_nhwc(x))
            skip = _nchw(pooled)
            pad = self.features - skip.shape[1]
            if pad > 0:
                skip = F.pad(skip, (0, 0, 0, 0, 0, pad))
        elif self.kind == "up":
            if pool_idx is None:
                raise ValueError("'up' bottleneck needs the matching "
                                 "encoder pool indices")
            skip = _nchw(max_unpool(_nhwc(self.skip_proj(x)), pool_idx))
        else:
            skip = x
        return self.out_act(y + skip), new_idx


# The stage-2/3 trunk (models/enet.py:712-728 of the JAX package):
# (suffix, kind, dilation), applied for the stage prefixes b2_ and b3_.
TRUNK = (
    ("1", "regular", 1), ("2", "dilated", 2), ("3", "asymmetric", 1),
    ("4", "dilated", 4), ("5", "regular", 1), ("6", "dilated", 8),
    ("7", "asymmetric", 1), ("8", "dilated", 16),
)


class ENet(nn.Module):
    """ENet.  Input (N, H, W, 3) float NHWC (H, W divisible by 8); output
    (N, H, W, num_classes) float32 logits.  Computes in the dtype of its
    parameters."""

    def __init__(self, num_classes: int = 15):
        super().__init__()
        self.num_classes = num_classes
        self.initial = InitialBlock()
        self.b1_0 = Bottleneck(16, 64, "down")
        for i in range(1, 5):
            setattr(self, f"b1_{i}", Bottleneck(64, 64, "regular"))
        self.b2_0 = Bottleneck(64, 128, "down")
        for stage in (2, 3):
            for suffix, kind, dil in TRUNK:
                setattr(self, f"b{stage}_{suffix}",
                        Bottleneck(128, 128, kind, dilation=dil))
        self.b4_0 = Bottleneck(128, 64, "up")
        self.b4_1 = Bottleneck(64, 64, "regular")
        self.b4_2 = Bottleneck(64, 64, "regular")
        self.b5_0 = Bottleneck(64, 16, "up")
        self.b5_1 = Bottleneck(16, 16, "regular")
        self.fullconv = ConvTranspose(16, num_classes, bias=True)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None
                         ) -> None:
        """LeCun-normal conv kernels from ``generator``; BatchNorm and
        PReLU at their Flax initial values."""
        for mod in self.modules():
            if isinstance(mod, (Conv, ConvTranspose)):
                w = mod.weight
                fan_in = (w.shape[1] if isinstance(mod, Conv)
                          else w.shape[0]) * w.shape[2] * w.shape[3]
                w.copy_(torch.randn(w.shape, generator=generator)
                        / math.sqrt(fan_in))
            elif isinstance(mod, BatchNorm):
                mod.fold()

    @torch.no_grad()
    def round_weights_bf16(self) -> None:
        """``_w16``: round every float parameter and statistic to a
        bfloat16 value (kept in f32 tensors) and refold the BatchNorms
        from them as the JAX ``enet_w16`` engine does.  That engine folds
        the shift in bf16 too in the blocks it runs in its transposed
        inference layout (the stem and every block at 16 or 64 channels)
        and leaves it to Flax's BatchNorm in the 128-channel stage-2/3
        blocks."""
        for t in list(self.parameters()) + list(self.buffers()):
            if t.is_floating_point():
                t.copy_(t.to(torch.bfloat16).float())
        for name, mod in self.named_modules():
            if isinstance(mod, BatchNorm):
                mod.fold_bf16(round_shift=not name.startswith(("b2_", "b3_")))

    @property
    def dtype(self) -> torch.dtype:
        return self.initial.Conv_0.weight.dtype

    def check_input(self, x: torch.Tensor) -> None:
        if x.dim() != 4 or x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError(
                f"ENet needs NHWC input with H, W divisible by 8 "
                f"(3 levels of 2x down/up-sampling); got {tuple(x.shape)}")

    def encode(self, x: torch.Tensor):
        """NHWC frame batch → (NCHW 1/8-res map, idx1, idx2): the stem,
        stage 1 and the stage-2 downsampling block."""
        self.check_input(x)
        x = _nchw(x.to(self.dtype))
        x = self.initial(x)
        x, idx1 = self.b1_0(x)
        for i in range(1, 5):
            x, _ = getattr(self, f"b1_{i}")(x)
        x, idx2 = self.b2_0(x)
        return x, idx1, idx2

    def trunk(self, x: torch.Tensor) -> torch.Tensor:
        """The 16 stage-2/3 bottlenecks at 1/8 resolution (NCHW)."""
        for stage in (2, 3):
            for suffix, _, _ in TRUNK:
                x, _ = getattr(self, f"b{stage}_{suffix}")(x)
        return x

    def decode(self, x: torch.Tensor, idx1: torch.Tensor,
               idx2: torch.Tensor) -> torch.Tensor:
        """Stages 4 and 5 and the full-resolution head → NHWC f32 logits."""
        x, _ = self.b4_0(x, idx2)
        x, _ = self.b4_1(x)
        x, _ = self.b4_2(x)
        x, _ = self.b5_0(x, idx1)
        x, _ = self.b5_1(x)
        return _nhwc(self.fullconv(x)).float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, idx1, idx2 = self.encode(x)
        return self.decode(self.trunk(x), idx1, idx2)


__all__ = ["ENet", "InitialBlock", "Bottleneck", "ConvBNAct", "Conv",
           "ConvTranspose", "BatchNorm", "PReLU", "TRUNK",
           "max_pool_with_indices", "max_unpool"]
