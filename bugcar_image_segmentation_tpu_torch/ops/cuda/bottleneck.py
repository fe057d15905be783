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
bf16 launches run on the tensor cores and read the weights rounded to bf16
once (:func:`pack_weights`), with the roundings of an f32 FMA chain over
the input channels in order; f32 launches run FMA chains on the f32
weights.  :func:`plan` says how a launch is cut.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple, Union

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


# The device type launch_args takes, and the stream it launches on; the
# CPU tests replace both to read the arguments it marshals.
_CARD = "cuda"


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


def _taps(kind: str) -> int:
    return 10 if kind == "asymmetric" else 9


def pack_elems(kind: str) -> int:
    """bf16 elements of one block's packed weights: the projection, the
    core taps and the expansion."""
    return WIDTH * MID + _taps(kind) * MID * MID + MID * WIDTH


def _core_matrix(wcore: Core, kind: str) -> torch.Tensor:
    """The core taps as one (taps * MID, MID) [tap, in][out] matrix."""
    if kind == "asymmetric":
        return torch.cat([w.reshape(-1, MID) for w in wcore])
    return wcore.reshape(-1, MID)


def _fragments(w: torch.Tensor) -> torch.Tensor:
    """A (K, N) B matrix rounded to bf16, in mma.sync m16n8k16 B-fragment
    order: blocks (k16 step, n8 tile), k-major; in a block, lane 4g + t
    holds rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g."""
    k, n = w.shape
    f = w.detach().to(torch.bfloat16).reshape(k // 16, 2, 4, 2, n // 8, 8)
    return f.permute(0, 4, 5, 2, 1, 3).reshape(-1)   # [kk, j, g, t, half, e]


def pack_weights(wp: torch.Tensor, wcore: Core, we: torch.Tensor, *,
                 kind: str = "regular") -> torch.Tensor:
    """The bf16 kernel's weights: wp (128, 32), the core taps (taps * 32,
    32) and we (32, 128), each rounded to bf16 once (the TPU kernel's cast
    of its matmul operands) and laid out in mma fragment order, one after
    the other; 1-D, contiguous, on wp's device.  Keep it beside the f32
    weights (``FusedBlock`` does)."""
    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    return torch.cat([_fragments(wp), _fragments(_core_matrix(wcore, kind)),
                      _fragments(we)]).contiguous()


def plan(n: int, h: int, w: int, kind: str, dilation: int,
         dtype: torch.dtype = torch.bfloat16) -> dict:
    """How a launch is cut, as the kernel source cuts it
    (``bugcar_fused_bottleneck_plan``; needs the built library): the
    kernel, CTAs (the batch n only repeats the grid), threads a CTA, output
    pixels a CTA and the y1 tile a CTA projects (rows x columns: 16 + 2
    min(d, 16), 16 when d >= w, 20 for the 1x5)."""
    import ctypes

    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    bf16 = dtype == torch.bfloat16
    out = (ctypes.c_int * 5)()
    _build.check(_build.library().bugcar_fused_bottleneck_plan(
        n, h, w, int(kind == "asymmetric"), int(dilation), int(bf16), out),
        "fused_bottleneck plan")
    return {"kernel": "fused_bottleneck_mma" if bf16
            else "fused_bottleneck_tile",
            "ctas": out[0], "threads": out[1], "px_per_cta": out[2],
            "y1_tile": [out[3], out[4]]}


def _param(t: torch.Tensor, shape: Tuple[int, ...], name: str,
           device: torch.device) -> int:
    # the messages are formatted only when a check fails (this runs for
    # every argument of every launch)
    if (t.device != device or t.dtype != torch.float32 or t.shape != shape
            or not t.is_contiguous()):
        _need(t.device == device, f"{name} is on {t.device}, x on {device}")
        _need(t.dtype == torch.float32,
              f"{name} must be float32, got {t.dtype}")
        _need(tuple(t.shape) == shape,
              f"{name} must have shape {shape}, got {tuple(t.shape)}")
        _need(False, f"{name} must be contiguous")
    return t.data_ptr()


_VEC_C, _VEC_M = (WIDTH,), (MID,)
_WP, _WE, _W33 = (WIDTH, MID), (MID, WIDTH), (3, 3, MID, MID)
_W51, _W15 = (5, 1, MID, MID), (1, 5, MID, MID)


def _core_ptr(wcore: Core, kind: str, device: torch.device
              ) -> Tuple[int, torch.Tensor]:
    """Pointer to the core taps as (taps, mid, mid) [in][out] f32, and the
    tensor that owns the memory (kept alive across the launch)."""
    if kind != "asymmetric":
        return _param(wcore, _W33, "wcore", device), wcore
    w51, w15 = wcore
    p51 = _param(w51, _W51, "wcore[0]", device)
    p15 = _param(w15, _W15, "wcore[1]", device)
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
                dilation: int = 1, packed: Optional[torch.Tensor] = None
                ) -> Tuple[tuple, tuple]:
    """Check a CUDA launch's arguments and marshal them for the C launcher:
    (the launcher's argument tuple, on the current stream; the tensors
    that own memory it points to and were made here -- the core taps, the
    packed weights -- to keep alive while the tuple is used).  bf16 x
    needs the packed weights (:func:`pack_weights`); None packs them
    here."""
    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    # the messages are formatted only when a check fails
    if x.device.type != _CARD:
        _need(False, f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.shape[-1] != WIDTH:
        _need(False, f"x must be (N, H, W, {WIDTH}), got {tuple(x.shape)}")
    bf16 = x.dtype == torch.bfloat16
    if not bf16 and x.dtype != torch.float32:
        _need(False, f"x must be float32 or bfloat16, got {x.dtype}")
    _need(x.is_contiguous(), "x must be contiguous")
    _need(out.shape == x.shape and out.dtype == x.dtype
          and out.device == x.device and out.is_contiguous(),
          "out must be a contiguous tensor like x")
    dilation = int(dilation)
    if dilation < 1:
        _need(False, f"dilation must be >= 1, got {dilation}")
    dev = x.device
    n, h, w, c = x.shape
    core_ptr, core_owner = _core_ptr(wcore, kind, dev)
    ptrs = (_param(wp, _WP, "wp", dev), _param(s1, _VEC_M, "s1", dev),
            _param(b1, _VEC_M, "b1", dev), _param(a1, _VEC_M, "a1", dev),
            core_ptr, _param(s2, _VEC_M, "s2", dev),
            _param(b2, _VEC_M, "b2", dev), _param(a2, _VEC_M, "a2", dev),
            _param(we, _WE, "we", dev), _param(s3, _VEC_C, "s3", dev),
            _param(b3, _VEC_C, "b3", dev), _param(ao, _VEC_C, "ao", dev))
    pack_ptr = 0
    if bf16:
        if packed is None:
            packed = pack_weights(wp, wcore, we, kind=kind)
        if (packed.device != dev or packed.dtype != torch.bfloat16
                or packed.shape != (pack_elems(kind),)
                or not packed.is_contiguous()):
            _need(False, f"packed must be a contiguous bfloat16 tensor of "
                         f"shape ({pack_elems(kind)},) on {dev} (pack_weights"
                         f"), got {packed.dtype} {tuple(packed.shape)} on "
                         f"{packed.device}")
        pack_ptr = packed.data_ptr()
    args = (x.data_ptr(), out.data_ptr(), n, h, w, c, MID, *ptrs, pack_ptr,
            int(kind == "asymmetric"), dilation, int(bf16), _stream(dev))
    return args, (core_owner, packed)


def fused_bottleneck(x: torch.Tensor,
                     wp: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                     a1: torch.Tensor,
                     wcore: Core,
                     s2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                     we: torch.Tensor, s3: torch.Tensor, b3: torch.Tensor,
                     ao: torch.Tensor,
                     *, kind: str = "regular",
                     dilation: int = 1,
                     packed: Optional[torch.Tensor] = None) -> torch.Tensor:
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
      packed: for bf16 x on the card, :func:`pack_weights` of wp, wcore
        and we, made once by the caller; None packs them at every call.

    Returns (N, H, W, 128) in x's dtype.  CPU tensors run the plain
    version; CUDA tensors launch the kernel or raise.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    if x.device.type == "cpu":
        return fused_bottleneck_ref(x, wp, s1, b1, a1, wcore, s2, b2, a2,
                                    we, s3, b3, ao, kind=kind,
                                    dilation=dilation)
    if x.device.type != "cuda":
        _need(False, f"x must be a CPU or CUDA tensor, got {x.device}")
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        args, _keep_alive = launch_args(
            x, out, wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao,
            kind=kind, dilation=dilation, packed=packed)
        lib = _build.library()
        err = lib.bugcar_fused_bottleneck(*args)
    if err != 0:
        smem = lib.bugcar_fused_bottleneck_smem_bytes(
            int(kind == "asymmetric"), x.shape[2], int(dilation),
            int(x.dtype == torch.bfloat16))
        _build.check(err, f"fused_bottleneck launch (x {tuple(x.shape)}, "
                          f"{smem} B of shared memory per block)")
    LAUNCHES["fused_bottleneck"] += 1
    return out


__all__ = ["fused_bottleneck", "fused_bottleneck_ref", "fold_bn",
           "launch_args", "pack_weights", "pack_elems", "plan", "KINDS"]
