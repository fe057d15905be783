"""Fused-kernel inference executor for ENet.

Port of ``bugcar_image_segmentation_tpu/models/enet_fused.py``: runs the
parameters of a :class:`~.enet.ENet` but executes the stage-2/3 trunk — 16
regular/dilated/asymmetric bottlenecks at 1/8 resolution — as one CUDA
kernel launch per bottleneck (``ops/cuda/bottleneck.py``).  The stem, the
down/up-sampling bottlenecks, stages 1/4/5 and the head run the ENet
module's own layers.

Inference only.  The kernels' arguments — squeezed HWIO weights and
BatchNorm folded in f32 (for ``_w16``, the f32 values of the bf16-rounded
fold), and the weights rounded to bf16 once in the bf16 kernel's mma
fragment order (``pack_weights``) — are buffers of this module, made from
the ENet at construction; build it from the float32 ENet (before any cast
to bfloat16, after any ``round_weights_bf16``), as
:func:`~.api.build_engine` does, and rebuild it after loading new weights.
"""

from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn as nn

from ..ops.cuda.bottleneck import fold_bn, fused_bottleneck, pack_weights
from .enet import ENet, TRUNK, BatchNorm, ConvBNAct


def _fold(bn: BatchNorm) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's folded scale and bias: :func:`fold_bn` in f32 from the
    parameters, or — after ``ENet.round_weights_bf16`` (``_w16``) — the
    BatchNorm's own bf16-rounded fold, in f32."""
    if bn.folded_bf16:
        return bn.mul.detach().float().clone(), bn.add.detach().float().clone()
    return fold_bn({"scale": bn.scale, "bias": bn.bias},
                   {"mean": bn.mean, "var": bn.var}, eps=bn.eps)


def _hwio(w: torch.Tensor) -> torch.Tensor:
    return w.detach().float().permute(2, 3, 1, 0).contiguous()


def _cba(mod: ConvBNAct):
    """ConvBNAct → (HWIO kernel, folded scale, folded bias, slope?)."""
    scale, bias = _fold(mod.BatchNorm_0)
    alpha = (mod.PReLU_0.alpha.detach().float()
             if mod.PReLU_0 is not None else None)
    return _hwio(mod.Conv_0.weight), scale, bias, alpha


class FusedBlock(nn.Module):
    """The kernel arguments of one trunk bottleneck, as buffers."""

    NAMES = ("wp", "s1", "b1", "a1", "s2", "b2", "a2", "we", "s3", "b3",
             "ao")

    def __init__(self, block: nn.Module, kind: str, dilation: int):
        super().__init__()
        self.kind, self.dilation = kind, dilation
        wp, s1, b1, a1 = _cba(block.proj)
        c, mid = wp.shape[2], wp.shape[3]
        we, s3, b3, _ = _cba(block.expand)
        if kind == "asymmetric":
            w51 = _hwio(block.conv_5x1.weight)             # (5, 1, mid, mid)
            w15, s2, b2, a2 = _cba(block.conv_1x5)         # (1, 5, mid, mid)
            # One buffer, 5x1 taps then 1x5 taps: the kernel's layout.
            core = torch.cat([w51.reshape(-1), w15.reshape(-1)])
        else:
            core, s2, b2, a2 = _cba(block.conv)            # (3, 3, mid, mid)
        vals = dict(wp=wp.reshape(c, mid), s1=s1, b1=b1, a1=a1, s2=s2, b2=b2,
                    a2=a2, we=we.reshape(mid, c), s3=s3, b3=b3,
                    ao=block.out_act.alpha.detach().float())
        for name in self.NAMES:
            self.register_buffer(name, vals[name].contiguous())
        self.register_buffer("core", core.contiguous())
        self.mid = mid
        # the bf16 kernel's weights: rounded to bf16 once, fragment order
        self.register_buffer("packed", pack_weights(
            self.wp, self.wcore(), self.we, kind=kind))

    def wcore(self):
        if self.kind != "asymmetric":
            return self.core
        m2 = self.mid * self.mid
        return (self.core[:5 * m2].view(5, 1, self.mid, self.mid),
                self.core[5 * m2:].view(1, 5, self.mid, self.mid))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H, W, C) contiguous → (N, H, W, C)."""
        return fused_bottleneck(
            x, self.wp, self.s1, self.b1, self.a1, self.wcore(), self.s2,
            self.b2, self.a2, self.we, self.s3, self.b3, self.ao,
            kind=self.kind, dilation=self.dilation, packed=self.packed)


class FusedENet(nn.Module):
    """ENet forward with the fused-kernel trunk; NHWC in, f32 NHWC
    logits out, like :class:`~.enet.ENet`."""

    def __init__(self, enet: ENet):
        super().__init__()
        self.enet = enet
        blocks: List[FusedBlock] = []
        for stage in (2, 3):
            for suffix, kind, dil in TRUNK:
                blocks.append(FusedBlock(getattr(enet, f"b{stage}_{suffix}"),
                                         kind, dil))
        self.blocks = nn.ModuleList(blocks)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, idx1, idx2 = self.enet.encode(x)
        y = x.permute(0, 2, 3, 1).contiguous()       # NHWC for the kernel
        for block in self.blocks:
            y = block(y)
        return self.enet.decode(y.permute(0, 3, 1, 2), idx1, idx2)


def enet_fused_apply(enet: ENet, x: torch.Tensor) -> torch.Tensor:
    """One fused forward of ``enet`` (f32 parameters) on NHWC ``x``;
    builds the kernel arguments on every call — for tests and one-off
    use; serving keeps a :class:`FusedENet`."""
    return FusedENet(enet)(x)


__all__ = ["FusedENet", "FusedBlock", "enet_fused_apply"]
