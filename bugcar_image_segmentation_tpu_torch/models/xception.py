"""DeepLabV3+ over Modified Aligned Xception-65 in PyTorch, NHWC.

Port of ``bugcar_image_segmentation_tpu/models/xception.py`` (the
architecture-faithful twin of the reference's ``deeplab.pb``; Chen et
al., 2018): separable convs with BatchNorm + ReLU after every depthwise,
entry flow (stem, blocks of 128 / 256 / 728 at stride 2), 16 identity-skip
middle blocks at output stride 16, exit flow at dilation 2 (1024, 1536,
2048), ASPP at rates 6 / 12 / 18 with an image-pool branch, and the
decoder that fuses block 2's 1/4-resolution tap (48 + 256 channels).

The module tree follows the Flax variable tree (``block1.sep0.depthwise``
↔ ``params/block1/sep0/depthwise/kernel``; conv ``kernel`` HWIO ↔
``weight`` OIHW, the depthwise (3, 3, 1, C) ↔ (C, 1, 3, 3); BatchNorm's
running ``mean``/``var`` are buffers), so ``convert/flax_xception.py``
maps a Flax tree onto it one leaf at a time.

``fused_sepconv`` sends the dilation-1 separable convs through the CUDA
kernel of ``ops/cuda/sepconv.py`` (the plain version on CPU tensors)
where the JAX model sends them through its Pallas kernel: the same gate
(:meth:`SepConvBN.uses_kernel`), so the port's ``_fs`` is the same
function as the JAX ``_fs`` — 7 entry-flow sites and 3 per middle block,
55 launches per backbone batch at the default 16 middle blocks, in eval
mode only.  The exit flow (dilation 2) always takes the plain path.
Train mode (``train()``) is the Flax module's ``train=True``: batch
statistics, full-resolution logits, plain convs everywhere.

``pw_int8`` (engine suffix ``_int8``) computes the pointwise 1x1s with C
and F both >= 512 (block 3's sep1 and sep2, the middle flow, the exit
flow) by the W8A8 int8 product of ``ops/quant.py`` (``Int8Conv1x1``),
from int8 weights made from the f32 pointwise kernel (eval mode only);
as in the JAX model it turns the fused kernel off at every site.

Numerics, as the Flax module: conv weights are used in the activation
dtype (:meth:`Xception65DeepLab.to_compute_dtype` casts them once),
BatchNorm computes in f32 from f32 parameters, the fused kernel takes its
arguments folded from the f32 parameters before that cast (its pointwise
weights rounded once to the compute dtype, where it would round them),
and the final x4 upsample of the logits runs in f32.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.nn as nn

from ..ops import quant as q8
from ..ops.cuda.sepconv import fold_bn, fused_sepconv
from .deeplab import ASPP, BN_EPS, ConvBN, _upsample
from .layers import BatchNorm, Conv

FUSE_CHOICES = (False, True, "all", "entry", "middle", "block1", "block2",
                "block3")


class SepConvBN(nn.Module):
    """Separable conv, DeepLab-Xception flavour: depthwise 3x3 → BN → ReLU
    → pointwise 1x1 → BN (→ ReLU)."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilation: int = 1, act_out: bool = True,
                 fused: bool = False, pw_int8: bool = False):
        super().__init__()
        self.stride, self.dilation = stride, dilation
        self.act_out, self.fused = act_out, fused and not pw_int8
        # JAX Int8Conv1x1's site: the int8 path and C, F >= 512
        self.int8 = pw_int8 and q8.gated(cin, features)
        self._w8 = None
        self.depthwise = Conv(cin, cin, 3, stride, groups=cin, bias=False,
                              dilation=dilation)
        self.depthwise_bn = BatchNorm(cin, BN_EPS)
        self.pointwise = Conv(cin, features, 1, bias=False)
        self.pointwise_bn = BatchNorm(features, BN_EPS)
        self._kernel_args: Union[Dict[str, torch.Tensor], None] = None
        self.train(False)   # built to serve, as BatchNorm is

    def uses_kernel(self, x: torch.Tensor) -> bool:
        """The JAX model's gate (xception.py ``use_fused``): eval mode,
        fused, dilation 1, and stride 1, or stride 2 on even H, W with
        C == 128 (the Pallas kernel's strided load needs 128 lanes).  In
        train mode the kernel, which has no backward and folds the running
        statistics, gives way to the plain convs and batch statistics."""
        h, w, c = x.shape[1], x.shape[2], x.shape[3]
        return (not self.training and bool(self.fused)
                and self.dilation == 1
                and (self.stride == 1
                     or (self.stride == 2 and h % 2 == 0 and w % 2 == 0
                         and c == 128)))

    def fold(self, dtype: torch.dtype = torch.float32
             ) -> Dict[str, torch.Tensor]:
        """The kernel's arguments from the current (f32) parameters: the
        depthwise kernel as (3, 3, 1, C) and both BatchNorms folded, f32;
        the pointwise as (C, F) rounded once to the compute ``dtype``, as
        the kernel would round it; cached until the next :meth:`fold`."""
        def bn(m: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
            return fold_bn({"scale": m.scale, "bias": m.bias},
                           {"mean": m.mean, "var": m.var}, m.eps)

        with torch.no_grad():
            s1, b1 = bn(self.depthwise_bn)
            s2, b2 = bn(self.pointwise_bn)
            wdw = self.depthwise.weight.float().permute(2, 3, 1, 0)
            wpw = self.pointwise.weight.float()[:, :, 0, 0].t()
            self._kernel_args = {
                "wdw": wdw.contiguous(), "s1": s1.contiguous(),
                "b1": b1.contiguous(), "wpw": wpw.to(dtype).contiguous(),
                "s2": s2.contiguous(), "b2": b2.contiguous()}
        return self._kernel_args

    def pointwise_int8(self, y: torch.Tensor) -> torch.Tensor:
        """The JAX ``Int8Conv1x1``: ``int8_matmul`` of the pixels by the
        pointwise kernel, quantized from its f32 values at the first
        call, cast to y's dtype."""
        if self._w8 is None:
            self._w8 = q8.quantize_weight_int8(
                self.pointwise.weight.float()[:, :, 0, 0].t())
        return q8.int8_linear(y, *self._w8).to(y.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.uses_kernel(x):
            a = self._kernel_args or self.fold()
            return fused_sepconv(x, a["wdw"], a["s1"], a["b1"], a["wpw"],
                                 a["s2"], a["b2"], strides=self.stride,
                                 act_out=self.act_out)
        y = torch.relu(self.depthwise_bn(self.depthwise(x)))
        y = (self.pointwise_int8(y) if self.int8 and not self.training
             else self.pointwise(y))
        y = self.pointwise_bn(y)
        return torch.relu(y) if self.act_out else y


class XceptionBlock(nn.Module):
    """Three separable convs + a residual: ``skip`` "conv" (1x1 stride-s
    conv + BN shortcut), "sum" (identity) or "none".  The stride sits on
    the last separable conv.  Returns (y, the second sepconv's output)."""

    def __init__(self, cin: int, features: Tuple[int, int, int],
                 stride: int = 1, dilation: int = 1, skip: str = "conv",
                 fused: bool = False, pw_int8: bool = False):
        super().__init__()
        if skip not in ("conv", "sum", "none"):
            raise ValueError(f"skip must be conv, sum or none, got {skip!r}")
        self.skip = skip
        f0, f1, f2 = features
        kw = dict(dilation=dilation, fused=fused, pw_int8=pw_int8)
        self.sep0 = SepConvBN(cin, f0, **kw)
        self.sep1 = SepConvBN(f0, f1, **kw)
        self.sep2 = SepConvBN(f1, f2, stride, act_out=False, **kw)
        if skip == "conv":
            self.shortcut = Conv(cin, f2, 1, stride, bias=False)
            self.shortcut_bn = BatchNorm(f2, BN_EPS)

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        mid = self.sep1(self.sep0(x))
        y = self.sep2(mid)
        if self.skip == "conv":
            y = y + self.shortcut_bn(self.shortcut(x))
        elif self.skip == "sum":
            y = y + x
        return y, mid


class Xception65DeepLab(nn.Module):
    """DeepLabV3+ / Xception-65, output stride 16.

    Input (N, H, W, 3) NHWC with H, W divisible by 16, computed in
    :attr:`dtype`; output float32 logits (float64 for a float64 model),
    (N, H, W, classes), or (N, H/4, W/4, classes) with
    ``head_upsample="quarter"`` in eval mode.  Train
    mode (``train()``) is the Flax module's ``train=True``: BatchNorm from
    the batch's statistics, full-resolution logits, and neither the fused
    kernel nor the int8 pointwise; :attr:`compute_dtype` computes in that
    dtype from f32 weights.  ``fused_sepconv``:
    False, True / "all" (entry and middle flows), "entry", "middle" or
    "block1" / "block2" / "block3", as the JAX model's.  ``pw_int8``: the
    int8 pointwise (module docstring); the JAX model's ``dw_shift``
    lowering is not ported.  ``rows``: a shard of a frame's rows
    (``parallel/spatial.py``).
    """

    compute_dtype: Optional[torch.dtype] = None
    rows = None

    def __init__(self, num_classes: int = 15, middle_blocks: int = 16,
                 head_upsample: str = "full",
                 fused_sepconv: Union[bool, str] = False,
                 pw_int8: bool = False):
        super().__init__()
        if head_upsample not in ("full", "quarter"):
            raise ValueError(f"head_upsample must be 'full' or 'quarter', "
                             f"got {head_upsample!r}")
        if fused_sepconv not in FUSE_CHOICES:
            raise ValueError(f"fused_sepconv must be one of {FUSE_CHOICES}, "
                             f"got {fused_sepconv!r}")
        self.num_classes = num_classes
        self.middle_blocks = middle_blocks
        self.head_upsample = head_upsample
        self.fused_sepconv = fused_sepconv
        self.pw_int8 = pw_int8
        q = dict(pw_int8=pw_int8)
        self.conv1_1 = ConvBN(3, 32, 3, 2)
        self.conv1_2 = ConvBN(32, 64, 3)
        self.block1 = XceptionBlock(64, (128, 128, 128), 2,
                                    fused=self._fuse("block1"), **q)
        self.block2 = XceptionBlock(128, (256, 256, 256), 2,
                                    fused=self._fuse("block2"), **q)
        self.block3 = XceptionBlock(256, (728, 728, 728), 2,
                                    fused=self._fuse("block3"), **q)
        for i in range(middle_blocks):
            setattr(self, f"middle{i}",
                    XceptionBlock(728, (728, 728, 728), skip="sum",
                                  fused=self._fuse("middle"), **q))
        self.exit1 = XceptionBlock(728, (728, 1024, 1024), dilation=2, **q)
        self.exit_sep0 = SepConvBN(1024, 1536, dilation=2, **q)
        self.exit_sep1 = SepConvBN(1536, 1536, dilation=2, **q)
        self.exit_sep2 = SepConvBN(1536, 2048, dilation=2, **q)
        self.aspp = ASPP(2048)
        self.low_proj = ConvBN(256, 48, 1)
        self.dec0 = ConvBN(256 + 48, 256, 3)
        self.dec1 = ConvBN(256, 256, 3)
        self.classifier = Conv(256, num_classes, 1)
        self.eval()     # the kernel and the quarter head serve until train()

    def _fuse(self, site: str) -> bool:
        f = self.fused_sepconv
        if f in (True, "all"):
            return True
        if f == "entry":
            return site.startswith("block")
        return f == site

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype is not None:
            return self.compute_dtype
        return self.conv1_1.Conv_0.weight.dtype

    def sepconvs(self):
        return [m for m in self.modules() if isinstance(m, SepConvBN)]

    def clear(self) -> None:
        """Forget the kernel arguments and int8 weights made from the
        parameters."""
        for m in self.sepconvs():
            m._kernel_args = m._w8 = None

    def load_state_dict(self, state_dict, strict: bool = True):
        out = super().load_state_dict(state_dict, strict)
        self.clear()
        return out

    def _apply(self, fn, *args, **kwargs):
        self.clear()
        return super()._apply(fn, *args, **kwargs)

    def to_compute_dtype(self, dtype: torch.dtype) -> "Xception65DeepLab":
        """Fold the kernel sites' arguments from the f32 parameters, then
        cast the conv weights to ``dtype`` once (Flax casts them at every
        use); BatchNorm stays f32, as Flax computes it, and so do the int8
        sites' pointwise kernels, which their int8 weights come from."""
        keep = set()
        for m in self.sepconvs():
            if m.fused:
                m.fold(dtype)
            if m.int8:
                keep.add(id(m.pointwise))
        for mod in self.modules():
            if isinstance(mod, Conv) and id(mod) not in keep:
                mod.to(dtype)
        return self

    # -- the forward, in the pieces a profile times --------------------------

    def entry(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stem and blocks 1-3: NHWC input → (1/16 map, block 2's tap)."""
        y = self.conv1_2(self.conv1_1(x.to(self.dtype)))
        y, _ = self.block1(y)
        y, low_level = self.block2(y)
        y, _ = self.block3(y)
        return y, low_level

    def middle(self, y: torch.Tensor) -> torch.Tensor:
        for i in range(self.middle_blocks):
            y, _ = getattr(self, f"middle{i}")(y)
        return y

    def exit_flow(self, y: torch.Tensor) -> torch.Tensor:
        y, _ = self.exit1(y)
        return self.exit_sep2(self.exit_sep1(self.exit_sep0(y)))

    def decode(self, y: torch.Tensor, low_level: torch.Tensor,
               out_hw: Tuple[int, int]) -> torch.Tensor:
        """ASPP output and block 2's tap → f32 logits (f64 for a
        float64 model; decoder and head)."""
        y = _upsample(y, (low_level.shape[1], low_level.shape[2]),
                      self.rows)
        ll = self.low_proj(low_level)
        y = torch.cat([y, ll.to(y.dtype)], dim=-1)
        y = self.classifier(self.dec1(self.dec0(y)))
        y = y.to(torch.promote_types(y.dtype, torch.float32))
        if self.head_upsample == "quarter" and not self.training:
            return y
        return _upsample(y, out_hw, self.rows)

    def check_input(self, x: torch.Tensor) -> None:
        if x.dim() != 4 or x.shape[1] % 16 or x.shape[2] % 16:
            raise ValueError(
                f"Xception65DeepLab needs NHWC input with H, W divisible "
                f"by 16 (output stride); got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.check_input(x)
        y, low_level = self.entry(x)
        y = self.aspp(self.exit_flow(self.middle(y)))
        return self.decode(y, low_level, (x.shape[1], x.shape[2]))


__all__ = ["Xception65DeepLab", "XceptionBlock", "SepConvBN",
           "FUSE_CHOICES"]
