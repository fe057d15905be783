"""One ENet trunk bottleneck as one CUDA kernel, its wrapper and its plain
PyTorch version.

Port of ``bugcar_image_segmentation_tpu/ops/pallas/bottleneck.py``
(``fused_bottleneck``, with the same signature, and ``fold_bn``).  The
kernel (``csrc/fused_bottleneck.cu``) computes, for NHWC ``x`` with 128
channels and a 32-wide projection:

    x → 1x1 proj → folded BN → PReLU → core conv → folded BN → PReLU
      → 1x1 expand → folded BN → + x → PReLU

where the core is a 3x3 conv with dilation d ("regular", "dilated") or a
5x1 conv (no BN/act) then a 1x5 ("asymmetric"), reading a zero-padded
copy of the projected map.  Matmul operands are the activation dtype,
accumulation is f32, and the intermediates are rounded to the activation
dtype where the TPU kernel rounds them (y1, the 5x1 result, y2).

:func:`fused_bottleneck` launches the kernel for CUDA tensors and runs
:func:`fused_bottleneck_ref` for CPU tensors; there is no other fallback.
"""

from __future__ import annotations

from typing import Mapping, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

from . import LAUNCHES
from . import build as _build

KINDS = ("regular", "dilated", "asymmetric")
WIDTH = 128       # channels the kernel takes
MID = 32          # projected width the kernel takes

Core = Union[torch.Tensor, Sequence[torch.Tensor]]


def fold_bn(bn_params: Mapping[str, torch.Tensor],
            bn_stats: Mapping[str, torch.Tensor],
            eps: float = 1e-3) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm → (scale, bias), f32: y = x * scale + bias."""
    var = bn_stats["var"].float()
    scale = bn_params["scale"].float() / torch.sqrt(var + eps)
    bias = bn_params["bias"].float() - bn_stats["mean"].float() * scale
    return scale, bias


def _prelu(v: torch.Tensor, a: torch.Tensor) -> torch.Tensor:
    return torch.where(v >= 0, v, a * v)


def fused_bottleneck_ref(x: torch.Tensor,
                         wp: torch.Tensor, s1: torch.Tensor,
                         b1: torch.Tensor, a1: torch.Tensor,
                         wcore: Core,
                         s2: torch.Tensor, b2: torch.Tensor,
                         a2: torch.Tensor,
                         we: torch.Tensor, s3: torch.Tensor,
                         b3: torch.Tensor, ao: torch.Tensor,
                         *, kind: str = "regular",
                         dilation: int = 1) -> torch.Tensor:
    """The plain PyTorch version of the kernel: same arguments, same
    rounding points, convolutions by ``F.conv2d`` in f32."""
    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    dt = x.dtype
    c, mid = wp.shape

    def q(t):   # a value as the activation dtype holds it, computed in f32
        return t.to(dt).float()

    def vec(v):
        return v.float().reshape(1, -1, 1, 1)

    xf = x.float().permute(0, 3, 1, 2)
    y1 = F.conv2d(xf, q(wp).t().reshape(mid, c, 1, 1))
    y1 = q(_prelu(y1 * vec(s1) + vec(b1), vec(a1)))
    if kind == "asymmetric":
        w51, w15 = wcore
        z = q(F.conv2d(y1, q(w51).permute(3, 2, 0, 1), padding=(2, 0)))
        acc = F.conv2d(z, q(w15).permute(3, 2, 0, 1), padding=(0, 2))
    else:
        d = int(dilation)
        acc = F.conv2d(y1, q(wcore).permute(3, 2, 0, 1), padding=d,
                       dilation=d)
    y2 = q(_prelu(acc * vec(s2) + vec(b2), vec(a2)))
    y3 = F.conv2d(y2, q(we).t().reshape(c, mid, 1, 1)) * vec(s3) + vec(b3)
    out = _prelu(y3 + xf, vec(ao))
    return out.to(dt).permute(0, 2, 3, 1).contiguous()


def _need(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(f"fused_bottleneck: {msg}")


def _param(t: torch.Tensor, shape: Tuple[int, ...], name: str,
           device: torch.device) -> int:
    _need(t.device == device, f"{name} is on {t.device}, x on {device}")
    _need(t.dtype == torch.float32, f"{name} must be float32, got {t.dtype}")
    _need(tuple(t.shape) == shape,
          f"{name} must have shape {shape}, got {tuple(t.shape)}")
    _need(t.is_contiguous(), f"{name} must be contiguous")
    return t.data_ptr()


def _core_ptr(wcore: Core, kind: str, device: torch.device
              ) -> Tuple[int, torch.Tensor]:
    """Pointer to the core taps as (taps, mid, mid) [in][out] f32, and the
    tensor that owns the memory (kept alive across the launch)."""
    if kind != "asymmetric":
        return _param(wcore, (3, 3, MID, MID), "wcore", device), wcore
    w51, w15 = wcore
    p51 = _param(w51, (5, 1, MID, MID), "wcore[0]", device)
    p15 = _param(w15, (1, 5, MID, MID), "wcore[1]", device)
    if p15 == p51 + w51.numel() * 4:
        # Views of one buffer, 5x1 taps then 1x5 taps: the kernel's layout.
        return p51, w51
    both = torch.cat([w51.reshape(-1), w15.reshape(-1)])
    return both.data_ptr(), both


def launch_args(x: torch.Tensor, out: torch.Tensor,
                wp: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                a1: torch.Tensor, wcore: Core,
                s2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                we: torch.Tensor, s3: torch.Tensor, b3: torch.Tensor,
                ao: torch.Tensor, *, kind: str = "regular",
                dilation: int = 1) -> Tuple[tuple, torch.Tensor]:
    """Check a CUDA launch's arguments and marshal them for the C launcher:
    (the launcher's argument tuple, on the current stream; the tensor that
    owns the core taps, to keep alive while the tuple is used)."""
    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    _need(x.device.type == "cuda", f"x must be a CUDA tensor, got "
                                   f"{x.device}")
    _need(x.dim() == 4 and x.shape[-1] == WIDTH,
          f"x must be (N, H, W, {WIDTH}), got {tuple(x.shape)}")
    _need(x.dtype in (torch.float32, torch.bfloat16),
          f"x must be float32 or bfloat16, got {x.dtype}")
    _need(x.is_contiguous(), "x must be contiguous")
    _need(out.shape == x.shape and out.dtype == x.dtype
          and out.device == x.device and out.is_contiguous(),
          "out must be a contiguous tensor like x")
    _need(int(dilation) >= 1, f"dilation must be >= 1, got {dilation}")
    dev = x.device
    n, h, w, c = x.shape
    ptrs = [_param(wp, (WIDTH, MID), "wp", dev)]
    ptrs += [_param(v, (MID,), name, dev)
             for v, name in ((s1, "s1"), (b1, "b1"), (a1, "a1"))]
    core_ptr, core_owner = _core_ptr(wcore, kind, dev)
    ptrs.append(core_ptr)
    ptrs += [_param(v, (MID,), name, dev)
             for v, name in ((s2, "s2"), (b2, "b2"), (a2, "a2"))]
    ptrs.append(_param(we, (MID, WIDTH), "we", dev))
    ptrs += [_param(v, (WIDTH,), name, dev)
             for v, name in ((s3, "s3"), (b3, "b3"), (ao, "ao"))]
    stream = torch.cuda.current_stream(dev).cuda_stream
    args = (x.data_ptr(), out.data_ptr(), n, h, w, c, MID, *ptrs,
            int(kind == "asymmetric"), int(dilation),
            int(x.dtype == torch.bfloat16), stream)
    return args, core_owner


def fused_bottleneck(x: torch.Tensor,
                     wp: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                     a1: torch.Tensor,
                     wcore: Core,
                     s2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                     we: torch.Tensor, s3: torch.Tensor, b3: torch.Tensor,
                     ao: torch.Tensor,
                     *, kind: str = "regular",
                     dilation: int = 1) -> torch.Tensor:
    """One ENet bottleneck (inference), fused.

    Args:
      x: (N, H, W, 128) float32 or bfloat16, contiguous.
      wp / we: (128, 32) / (32, 128) 1x1 kernels (squeezed HWIO), f32.
      wcore: (3, 3, 32, 32) HWIO for regular/dilated, or the pair
        ((5, 1, 32, 32), (1, 5, 32, 32)) for asymmetric, f32.
      s*/b*: folded BN scale/bias (:func:`fold_bn`); a1/a2/ao: PReLU
        slopes (projection / core / output); all f32 vectors.
      kind: "regular" | "dilated" | "asymmetric".
      dilation: the core conv's dilation (regular/dilated).

    Returns (N, H, W, 128) in x's dtype.  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    if x.device.type == "cpu":
        return fused_bottleneck_ref(x, wp, s1, b1, a1, wcore, s2, b2, a2,
                                    we, s3, b3, ao, kind=kind,
                                    dilation=dilation)
    _need(x.device.type == "cuda", f"x must be a CPU or CUDA tensor, "
                                   f"got {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        args, _keep_alive = launch_args(
            x, out, wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao,
            kind=kind, dilation=dilation)
        lib = _build.library()
        err = lib.bugcar_fused_bottleneck(*args)
    if err != 0:
        smem = lib.bugcar_fused_bottleneck_smem_bytes(
            int(kind == "asymmetric"), x.shape[2])
        _build.check(err, f"fused_bottleneck launch (x {tuple(x.shape)}, "
                          f"{smem} B of shared memory per block)")
    LAUNCHES["fused_bottleneck"] += 1
    return out


__all__ = ["fused_bottleneck", "fused_bottleneck_ref", "fold_bn",
           "launch_args", "KINDS"]
