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
f32 (``mul``, ``add`` buffers, refreshed when a state dict is loaded or by
:meth:`ENet.fold`), so casting the module to bfloat16 afterwards keeps the
f32 fold.  Train mode normalises with batch statistics as Flax does
(``layers.BatchNorm``) and applies spatial dropout from masks drawn
before the forward; its max pools keep ``amax``, whose gradient splits
between tied maxima as ``jnp.max``'s does.
:meth:`ENet.round_weights_bf16` serves from bf16-rounded weights
(``_w16``) and refolds as the JAX engine folds bf16 leaves.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import max_pool_with_indices, max_unpool
from . import layers
from .layers import _cast, _same_pads

BN_EPS = 1e-3
BN_MOMENTUM = 0.9
# spatial dropout rates (models/enet.py:704-707 of the JAX package): stage 1
# drops 1 % of the channels, every later bottleneck 10 %
DROPOUT_STAGE1, DROPOUT = 0.01, 0.1


class Conv(nn.Module):
    """``nn.Conv`` with Flax SAME padding (``kernel`` ↔ ``weight``);
    ``rows`` as :class:`~.layers.Conv`'s."""

    rows = None

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
        if self.rows is not None:
            x = self.rows.conv_rows(x, 2, self.kernel[0], self.stride,
                                    self.dilation, th)
            th = bh = 0
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
    (2H+1, 2W+1) output dropped.  With ``rows`` (a shard of a frame's
    rows), the row above the shard feeds its first two output rows."""

    rows = None

    def __init__(self, cin: int, cout: int, bias: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cin, cout, 3, 3))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        top = 0
        if self.rows is not None:
            x, top = self.rows.halo(x, 2, 1, 0), 2
        y = F.conv_transpose2d(x, _cast(self.weight, x), _cast(self.bias, x),
                               stride=2)
        return y[:, :, top:top + 2 * h, :2 * w]


class BatchNorm(layers.BatchNorm):
    """BatchNorm over NCHW channels (eps 1e-3, momentum 0.9) with Flax's
    variable names.  Eval mode runs from constants folded in f32
    (``mul``, ``add``); train mode is :class:`~.layers.BatchNorm`'s, and
    after the parameters or statistics change the fold is stale until
    :meth:`fold` (:meth:`ENet.fold` refreshes every one)."""

    channel_dim = 1

    def __init__(self, c: int, eps: float = BN_EPS,
                 momentum: float = BN_MOMENTUM):
        super().__init__(c, eps, momentum)
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
        if self.training:
            return self.forward_train(x)
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

    Training applies spatial dropout to the main branch after the
    expansion: ``drop`` is an (N, C) mask of 0 and 1 / (1 - rate) (Flax's
    ``nn.Dropout(broadcast_dims=(1, 2))``), drawn by the caller
    (:meth:`ENet.dropout_masks`) so that a recomputed forward reuses it.
    """

    def __init__(self, cin: int, features: int, kind: str = "regular",
                 dilation: int = 1, projection_ratio: int = 4,
                 dropout_rate: float = DROPOUT):
        super().__init__()
        if kind not in ("regular", "dilated", "asymmetric", "down", "up"):
            raise ValueError(f"unknown bottleneck kind {kind!r}")
        self.kind, self.dilation, self.features = kind, dilation, features
        self.dropout_rate = dropout_rate
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
                drop: Optional[torch.Tensor] = None,
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
        if drop is not None:
            y = y * _cast(drop, y)[:, :, None, None]

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
    parameters, or in :attr:`compute_dtype` where that is set (training in
    bf16 from f32 master weights: each weight is cast where it is used).

    Train mode (``train()``) normalises with batch statistics and takes
    ``dropout``, the masks of :meth:`dropout_masks`; :meth:`fold` then
    refreshes the eval-mode BatchNorm constants from the new weights."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, num_classes: int = 15):
        super().__init__()
        self.num_classes = num_classes
        self.initial = InitialBlock()
        self.b1_0 = Bottleneck(16, 64, "down", dropout_rate=DROPOUT_STAGE1)
        for i in range(1, 5):
            setattr(self, f"b1_{i}", Bottleneck(64, 64, "regular",
                                                dropout_rate=DROPOUT_STAGE1))
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

    @torch.no_grad()
    def fold(self) -> None:
        """Refold every BatchNorm from the current parameters and running
        statistics (after training; serving from stale folds would run
        the old weights)."""
        for mod in self.modules():
            if isinstance(mod, BatchNorm):
                mod.fold()

    def bottlenecks(self):
        """(name, bottleneck) in forward order."""
        return [(n, m) for n, m in self.named_children()
                if isinstance(m, Bottleneck)]

    def dropout_masks(self, generator: torch.Generator, n: int
                      ) -> Dict[str, torch.Tensor]:
        """Spatial-dropout masks for a batch of ``n``: per bottleneck an
        (n, C) float32 tensor of 0 (dropped, with its rate) and 1 / (1 -
        rate), drawn on the CPU from ``generator`` in forward order."""
        out = {}
        for name, blk in self.bottlenecks():
            keep = 1.0 - blk.dropout_rate
            kept = torch.rand((n, blk.features), generator=generator) < keep
            out[name] = kept.float() / keep
        return out

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype is not None:
            return self.compute_dtype
        return self.initial.Conv_0.weight.dtype

    def check_input(self, x: torch.Tensor) -> None:
        if x.dim() != 4 or x.shape[1] % 8 or x.shape[2] % 8:
            raise ValueError(
                f"ENet needs NHWC input with H, W divisible by 8 "
                f"(3 levels of 2x down/up-sampling); got {tuple(x.shape)}")

    def _block(self, name: str, x: torch.Tensor, dropout,
               pool_idx: Optional[torch.Tensor] = None):
        drop = None if dropout is None else dropout[name]
        return getattr(self, name)(x, pool_idx, drop)

    def encode(self, x: torch.Tensor, dropout=None):
        """NHWC frame batch → (NCHW 1/8-res map, idx1, idx2): the stem,
        stage 1 and the stage-2 downsampling block."""
        self.check_input(x)
        x = _nchw(x.to(self.dtype))
        x = self.initial(x)
        x, idx1 = self._block("b1_0", x, dropout)
        for i in range(1, 5):
            x, _ = self._block(f"b1_{i}", x, dropout)
        x, idx2 = self._block("b2_0", x, dropout)
        return x, idx1, idx2

    def trunk(self, x: torch.Tensor, dropout=None) -> torch.Tensor:
        """The 16 stage-2/3 bottlenecks at 1/8 resolution (NCHW)."""
        for stage in (2, 3):
            for suffix, _, _ in TRUNK:
                x, _ = self._block(f"b{stage}_{suffix}", x, dropout)
        return x

    def decode(self, x: torch.Tensor, idx1: torch.Tensor,
               idx2: torch.Tensor, dropout=None) -> torch.Tensor:
        """Stages 4 and 5 and the full-resolution head → NHWC f32 logits."""
        x, _ = self._block("b4_0", x, dropout, idx2)
        x, _ = self._block("b4_1", x, dropout)
        x, _ = self._block("b4_2", x, dropout)
        x, _ = self._block("b5_0", x, dropout, idx1)
        x, _ = self._block("b5_1", x, dropout)
        return _nhwc(self.fullconv(x)).float()

    def forward(self, x: torch.Tensor,
                dropout: Optional[Dict[str, torch.Tensor]] = None
                ) -> torch.Tensor:
        """``dropout``: name → (N, C) mask (:meth:`dropout_masks`), applied
        in train mode; None applies none."""
        x, idx1, idx2 = self.encode(x, dropout)
        return self.decode(self.trunk(x, dropout), idx1, idx2, dropout)


__all__ = ["ENet", "InitialBlock", "Bottleneck", "ConvBNAct", "Conv",
           "ConvTranspose", "BatchNorm", "PReLU", "TRUNK",
           "max_pool_with_indices", "max_unpool"]
