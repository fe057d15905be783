"""The U-Net encoder-decoder (BASELINE config 3, the ``model.h5``
configuration) in PyTorch, NHWC.

Port of ``bugcar_image_segmentation_tpu/models/unet.py`` on its stock path
(``phase_max_width=0``, ``chw_max_width=0``): four encoder stages of two
3x3 convs (Flax SAME, no bias) with BatchNorm (eps 1e-3) and ReLU, each
followed by a 2x2 max pool (``ops/pooling.max_pool_2x2``); a 512-wide
bottleneck pair; four decoder stages, each a 2x2 stride-2 transposed conv
with bias, the encoder's skip concatenated after it, and a conv pair; a
1x1 classifier with bias.  Widths (32, 64, 128, 256), bottleneck 512.

The JAX package's 2x2 phase-space path (``unet_ph``) and its CHW path are
TPU layouts of the same sums and the same variable tree; they are not
ported (the engine ``unet_ph`` builds this module).

The transposed conv takes Flax's kernel orientation: ``y[2p + r, 2q + s]
= W[1 - r, 1 - s] @ x[p, q]`` (``fastconv.FastConvTranspose2x``), so its
``weight`` in ``conv_transpose2d``'s (in, out, kh, kw) layout is the Flax
kernel flipped in both spatial axes (``convert/flax_unet.py``).  Its bias
is added after the product is rounded to the activation dtype, as Flax
adds it.

Numerics, as the Flax module: conv weights are used in the activation
dtype (:meth:`UNet.to_compute_dtype` casts them once), BatchNorm computes
in f32 from f32 parameters, and the logits are cast to f32.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.pooling import max_pool_2x2
from .layers import BatchNorm, Conv, _cast

BN_EPS = 1e-3
UP_CONVS = ("up0", "up1", "up2", "up3")   # the transposed convs


class DoubleConv(nn.Module):
    """Two (3x3 conv → BatchNorm → ReLU)."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.conv0 = Conv(cin, features, 3, bias=False)
        self.bn0 = BatchNorm(features, BN_EPS)
        self.conv1 = Conv(features, features, 3, bias=False)
        self.bn1 = BatchNorm(features, BN_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.bn0(self.conv0(x)))
        return torch.relu(self.bn1(self.conv1(x)))


class UpConv2x(nn.Module):
    """Flax's ``nn.ConvTranspose(features, (2, 2), strides=(2, 2))`` with
    bias on NHWC tensors: ``weight`` (in, out, 2, 2), the Flax kernel
    flipped spatially."""

    def __init__(self, cin: int, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cin, features, 2, 2))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x.permute(0, 3, 1, 2).contiguous(
            memory_format=torch.channels_last)
        y = F.conv_transpose2d(y, _cast(self.weight, x), stride=2)
        return y.permute(0, 2, 3, 1) + self.bias.to(x.dtype)


class UNet(nn.Module):
    """Input (N, H, W, 3) NHWC with H, W divisible by 16, computed in
    :attr:`dtype`; output float32 logits (N, H, W, classes).  Train mode
    (``train()``): BatchNorm from batch statistics (momentum 0.99);
    :attr:`compute_dtype` computes in that dtype from f32 weights."""

    compute_dtype: Optional[torch.dtype] = None

    def __init__(self, num_classes: int = 15,
                 widths: Sequence[int] = (32, 64, 128, 256),
                 bottleneck_width: int = 512):
        super().__init__()
        self.num_classes = num_classes
        self.widths = tuple(widths)
        cin = 3
        for i, w in enumerate(self.widths):
            setattr(self, f"enc{i}", DoubleConv(cin, w))
            cin = w
        self.bottleneck = DoubleConv(cin, bottleneck_width)
        cin = bottleneck_width
        for i, w in enumerate(reversed(self.widths)):
            setattr(self, f"up{i}", UpConv2x(cin, w))
            setattr(self, f"dec{i}", DoubleConv(2 * w, w))
            cin = w
        self.classifier = Conv(cin, num_classes, 1)

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype is not None:
            return self.compute_dtype
        return self.enc0.conv0.weight.dtype

    def to_compute_dtype(self, dtype: torch.dtype) -> "UNet":
        """Cast the conv weights to ``dtype`` once (Flax casts them at
        every use); BatchNorm and the transposed convs' biases stay f32."""
        for mod in self.modules():
            if isinstance(mod, Conv):
                mod.to(dtype)
            elif isinstance(mod, UpConv2x):
                mod.weight.data = mod.weight.data.to(dtype)
        return self

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        div = 2 ** len(self.widths)
        if x.dim() != 4 or x.shape[1] % div or x.shape[2] % div:
            raise ValueError(f"UNet needs NHWC input with H, W divisible by "
                             f"{div}; got {tuple(x.shape)}")
        x = x.to(self.dtype)
        skips = []
        for i in range(len(self.widths)):
            x = getattr(self, f"enc{i}")(x)
            skips.append(x)
            x = max_pool_2x2(x)
        x = self.bottleneck(x)
        for i, skip in enumerate(reversed(skips)):
            x = getattr(self, f"up{i}")(x)
            x = getattr(self, f"dec{i}")(torch.cat([x, skip.to(x.dtype)],
                                                   dim=-1))
        return self.classifier(x).float()


__all__ = ["UNet", "DoubleConv", "UpConv2x", "UP_CONVS"]
