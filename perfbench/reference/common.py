"""What the plain references share: operand rounding, Flax SAME padding,
the half-pixel bilinear resize, norms.

Every product of a reference goes through :func:`conv2d`,
:func:`conv_transpose2d`, :func:`linear` or :func:`matmul`, which round
both operands by the active :class:`Precision` first:

- ``"f32"``: no rounding; float32 with TF32 off (:func:`exact_f32`);
- ``"fp8"``: each operand scaled per tensor to float8 e4m3's range,
  rounded to e4m3 and scaled back, the sums in float32.  This is the
  correctness control: the step below the bfloat16 the configurations
  state, as a later change that served in fp8 would take it.
"""

from __future__ import annotations

import contextlib
from typing import Tuple

import torch
import torch.nn.functional as F

FP8_MAX = 448.0     # largest finite float8 e4m3fn


class Precision:
    """The rounding applied to every product's operands."""

    def __init__(self, name: str = "f32"):
        if name not in ("f32", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "f32":
            return t
        amax = t.abs().amax().clamp_min(1e-12)
        scale = FP8_MAX / amax
        return (t * scale).to(torch.float8_e4m3fn).float() / scale


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32, restored afterwards."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def same_pads(size: int, k: int, stride: int, dilation: int = 1
              ) -> Tuple[int, int]:
    """(lo, hi) padding of one axis under XLA's SAME rule."""
    out = -(-size // stride)
    total = max((out - 1) * stride + (k - 1) * dilation + 1 - size, 0)
    return total // 2, total - total // 2


def conv2d(p: Precision, x: torch.Tensor, w: torch.Tensor, b=None,
           stride: int = 1, dilation: int = 1, groups: int = 1
           ) -> torch.Tensor:
    """NCHW convolution with SAME padding; ``w`` OIHW."""
    kh, kw = w.shape[2], w.shape[3]
    th, bh = same_pads(x.shape[2], kh, stride, dilation)
    tw, bw = same_pads(x.shape[3], kw, stride, dilation)
    x = F.pad(p(x), (tw, bw, th, bh))
    return F.conv2d(x, p(w), b, stride, 0, dilation, groups)


def linear(p: Precision, x: torch.Tensor, w: torch.Tensor, b=None
           ) -> torch.Tensor:
    """``x @ w.T + b`` over the last axis; ``w`` (out, in)."""
    return F.linear(p(x), p(w), b)


def matmul(p: Precision, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(p(a), p(b))


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float) -> torch.Tensor:
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * scale + bias


def lerp_axis(x: torch.Tensor, dim: int, dst: int) -> torch.Tensor:
    """Half-pixel-centre bilinear resampling of one axis with the edges
    replicated (cv2's INTER_LINEAR, and JAX's bilinear when it
    upsamples)."""
    src = x.shape[dim]
    pos = ((torch.arange(dst, dtype=torch.float64) + 0.5) * (src / dst)
           - 0.5)
    lo = torch.floor(pos)
    frac = (pos - lo).to(torch.float32).to(x.device)
    i0 = lo.long().clamp(0, src - 1).to(x.device)
    i1 = (lo.long() + 1).clamp(0, src - 1).to(x.device)
    shape = [1] * x.dim()
    shape[dim] = dst
    frac = frac.view(shape)
    return (x.index_select(dim, i0) * (1.0 - frac)
            + x.index_select(dim, i1) * frac)


def resize_bilinear(x: torch.Tensor, hw: Tuple[int, int],
                    axes: Tuple[int, int] = (-2, -1)) -> torch.Tensor:
    """Rows first, then columns."""
    if x.shape[axes[0]] != hw[0]:
        x = lerp_axis(x, axes[0], hw[0])
    if x.shape[axes[1]] != hw[1]:
        x = lerp_axis(x, axes[1], hw[1])
    return x
