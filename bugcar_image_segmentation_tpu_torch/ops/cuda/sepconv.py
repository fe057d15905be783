"""One Xception separable conv as one CUDA kernel, its wrapper and its
plain PyTorch version.

Port of ``bugcar_image_segmentation_tpu/ops/pallas/sepconv.py``
(``fused_sepconv``, with the same signature and return).  The kernel
(``csrc/fused_sepconv.cu``) computes, for NHWC ``x``:

    depthwise 3x3 (f32 taps) → ·s1 + b1 → ReLU → round to x's dtype
      → pointwise 1x1 with wpw rounded to x's dtype, f32 accumulation
      → ·s2 + b2 [→ ReLU] → x's dtype

(the kernel reads wpw already in x's dtype: the wrapper rounds an f32
wpw once, and a caller that keeps the rounded copy passes it as it is)

with stride 1 (pad 1 on every side) or stride 2 under Flax SAME padding
on even H, W (output (r, c) reads input rows and columns 2r..2r+2, zero
past the bottom and right edge).  BatchNorm comes folded (:func:`fold_bn`).

:func:`fused_sepconv` launches the kernel for CUDA tensors and runs
:func:`sepconv_reference` for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES
from . import build as _build
from .bottleneck import fold_bn


def _check_stride(x: torch.Tensor, strides: int) -> None:
    if strides not in (1, 2):
        raise ValueError(f"strides must be 1 or 2, got {strides}")
    if strides == 2 and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"strides=2 needs even H, W; got "
                         f"{tuple(x.shape[1:3])}")


def sepconv_reference(x: torch.Tensor, wdw: torch.Tensor,
                      s1: torch.Tensor, b1: torch.Tensor,
                      wpw: torch.Tensor, s2: torch.Tensor,
                      b2: torch.Tensor, *, strides: int = 1,
                      act_out: bool = True) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same arguments, same
    rounding points; the depthwise as a grouped ``conv2d`` in f32."""
    _check_stride(x, strides)
    dt = x.dtype
    c = x.shape[-1]
    xf = x.float().permute(0, 3, 1, 2)                 # NCHW view
    taps = wdw.float().reshape(3, 3, c).permute(2, 0, 1).unsqueeze(1)
    if strides == 1:
        acc = F.conv2d(xf, taps, padding=1, groups=c)
    else:
        acc = F.conv2d(F.pad(xf, (0, 1, 0, 1)), taps, stride=2, groups=c)
    acc = acc.permute(0, 2, 3, 1)                      # NHWC
    y1 = torch.relu(acc * s1.float() + b1.float())
    y2 = torch.matmul(y1.to(dt).float(), wpw.to(dt).float())
    y2 = y2 * s2.float() + b2.float()
    if act_out:
        y2 = torch.relu(y2)
    return y2.to(dt).contiguous()


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_sepconv: {msg}")


def _param(t: torch.Tensor, shape, name: str, device: torch.device,
           dtype: torch.dtype = torch.float32) -> int:
    _need(t.device == device, f"{name} is on {t.device}, x on {device}")
    _need(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
    _need(tuple(t.shape) == tuple(shape),
          f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    _need(t.is_contiguous(), f"{name} must be contiguous")
    return t.data_ptr()


def launch_args(x: torch.Tensor, out: torch.Tensor, wdw: torch.Tensor,
                s1: torch.Tensor, b1: torch.Tensor, wpw: torch.Tensor,
                s2: torch.Tensor, b2: torch.Tensor, *, strides: int = 1,
                act_out: bool = True) -> tuple:
    """Check a CUDA launch's arguments and marshal them for the C launcher
    ``bugcar_fused_sepconv`` (on the current stream); ``wpw`` in x's
    dtype."""
    _check_stride(x, strides)
    _need(x.device.type == "cuda", f"x must be a CUDA tensor, got "
                                   f"{x.device}")
    _need(x.dim() == 4, f"x must be (N, H, W, C), got {tuple(x.shape)}")
    _need(x.dtype in (torch.float32, torch.bfloat16),
          f"x must be float32 or bfloat16, got {x.dtype}")
    _need(x.is_contiguous(), "x must be contiguous (NHWC memory)")
    n, h, w, c = x.shape
    f = wpw.shape[-1]
    _need(min(n, h, w, c, f) >= 1, f"empty operand: x {tuple(x.shape)}, "
                                   f"wpw {tuple(wpw.shape)}")
    ho, wo = h // strides, w // strides
    _need(tuple(out.shape) == (n, ho, wo, f) and out.dtype == x.dtype
          and out.device == x.device and out.is_contiguous(),
          f"out must be a contiguous {x.dtype} (N, H/s, W/s, F) tensor")
    dev = x.device
    ptrs = [_param(wdw, (3, 3, 1, c), "wdw", dev),
            _param(s1, (c,), "s1", dev), _param(b1, (c,), "b1", dev),
            _param(wpw, (c, f), "wpw", dev, x.dtype),
            _param(s2, (f,), "s2", dev), _param(b2, (f,), "b2", dev)]
    stream = torch.cuda.current_stream(dev).cuda_stream
    return (x.data_ptr(), *ptrs, out.data_ptr(), n, h, w, c, f,
            int(strides), int(bool(act_out)),
            int(x.dtype == torch.bfloat16), stream)


def fused_sepconv(x: torch.Tensor, wdw: torch.Tensor,
                  s1: torch.Tensor, b1: torch.Tensor,
                  wpw: torch.Tensor, s2: torch.Tensor, b2: torch.Tensor,
                  *, strides: int = 1, act_out: bool = True) -> torch.Tensor:
    """One SepConvBN (inference), fused.

    Args:
      x: (N, H, W, C) float32 or bfloat16, contiguous; H, W even for
        strides=2.
      wdw: (3, 3, 1, C) Flax depthwise kernel (HWIO, groups=C), f32.
      s1/b1: folded depthwise-BN scale/bias (C,) f32 (:func:`fold_bn`).
      wpw: (C, F) squeezed pointwise kernel, f32 or already in x's dtype.
      s2/b2: folded pointwise-BN scale/bias (F,) f32.
      strides: 1 or 2 (both SAME-padded).
      act_out: trailing ReLU (blocks' sep2 omits it).

    Returns (N, H/strides, W/strides, F) in x's dtype.  CPU tensors run
    the plain version; CUDA tensors launch the kernel or raise.
    """
    if x.device.type == "cpu":
        return sepconv_reference(x, wdw, s1, b1, wpw, s2, b2,
                                 strides=strides, act_out=act_out)
    _check_stride(x, strides)
    _need(x.device.type == "cuda", f"x must be a CPU or CUDA tensor, got "
                                   f"{x.device}")
    n, h, w, _ = x.shape
    out = torch.empty((n, h // strides, w // strides, wpw.shape[-1]),
                      dtype=x.dtype, device=x.device)
    if wpw.dtype == torch.float32 and x.dtype != torch.float32:
        wpw = wpw.to(x.dtype)   # rounded where the kernel would round it
    with torch.cuda.device(x.device):
        args = launch_args(x, out, wdw, s1, b1, wpw, s2, b2,
                           strides=strides, act_out=act_out)
        err = _build.library().bugcar_fused_sepconv(*args)
    _build.check(err, f"fused_sepconv launch (x {tuple(x.shape)}, F "
                      f"{wpw.shape[-1]}, stride {strides}, {x.dtype})")
    LAUNCHES["fused_sepconv"] += 1
    return out


__all__ = ["fused_sepconv", "sepconv_reference", "fold_bn", "launch_args"]
