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

:func:`fused_bottleneck` checks its arguments and calls the
``bugcar::fused_bottleneck`` op (``library.py``), which launches the
kernel for CUDA tensors (:func:`launch`) and runs
:func:`fused_bottleneck_ref` for CPU tensors; there is no other fallback.
bf16 launches run on the tensor cores and read the weights rounded to bf16
once (:func:`pack_weights`), with the roundings of an f32 FMA chain over
the input channels in order; f32 launches run FMA chains on the f32
weights.  :func:`plan` says how a launch is cut.
"""

from __future__ import annotations

from typing import (List, Mapping, NamedTuple, Optional, Sequence, Tuple,
                    Union)

import torch
import torch.nn.functional as F

from . import counted
from . import build as _build
from . import library as _library

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


def _plain_values(x: torch.Tensor, wp, s1, b1, a1, wcore: Core, s2, b2,
                  a2, we, s3, b3, ao, *, kind: str, dilation: int) -> dict:
    """The plain version's values at the rounding points, NCHW f32 (as
    x's dtype holds them; "out" not yet rounded): "y1", "z" (asymmetric),
    "y2", "out"."""
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
    out = {"y1": q(_prelu(y1 * vec(s1) + vec(b1), vec(a1)))}
    if kind == "asymmetric":
        w51, w15 = wcore
        out["z"] = q(F.conv2d(out["y1"], q(w51).permute(3, 2, 0, 1),
                              padding=(2, 0)))
        acc = F.conv2d(out["z"], q(w15).permute(3, 2, 0, 1), padding=(0, 2))
    else:
        d = int(dilation)
        acc = F.conv2d(out["y1"], q(wcore).permute(3, 2, 0, 1), padding=d,
                       dilation=d)
    y2 = out["y2"] = q(_prelu(acc * vec(s2) + vec(b2), vec(a2)))
    y3 = F.conv2d(y2, q(we).t().reshape(c, mid, 1, 1)) * vec(s3) + vec(b3)
    out["out"] = _prelu(y3 + xf, vec(ao))
    return out


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
    out = _plain_values(x, wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3,
                        ao, kind=kind, dilation=dilation)["out"]
    return out.to(x.dtype).permute(0, 2, 3, 1).contiguous()


# -- the bf16 kernel's own arithmetic, plain ----------------------------------
#
# The bf16 kernel rounds y1, the 5x1 result z, y2 and the output to bf16 where
# the TPU kernel rounds them, each value the one an f32 FMA chain over the
# input channels in order (taps row by row) gives.  It sums on the tensor
# cores and settles every rounding with an error bound against that chain,
# recomputing by the chain what the bound cannot settle, so its bits are the
# chain's: :func:`fused_bottleneck_chain` computes them in plain torch.

ERR_ABS, ERR_ACC = 2 ** -17, 2 ** -18   # csrc/fused_bottleneck.cu kErr*


class RoundingPoint(NamedTuple):
    """One bf16 rounding point of the kernel: the f32 sum of ``inputs``
    (..., K) @ ``weights`` (K, N), then ``v * scale + bias`` (an f32 FMA;
    None: nothing), ``+ residual`` (or None), PReLU by ``slope`` (or None),
    rounded to bf16 (``value``, as f32; not kept for the output)."""

    name: str
    inputs: torch.Tensor
    weights: torch.Tensor
    scale: Optional[torch.Tensor]
    bias: Optional[torch.Tensor]
    residual: Optional[torch.Tensor]
    slope: Optional[torch.Tensor]
    value: Optional[torch.Tensor] = None    # the chain's bf16 result

    def finish(self, acc: torch.Tensor) -> torch.Tensor:
        """The f32 sum → the value before the bf16 rounding, in f32 steps
        as the kernel takes them (in f64 for an f64 ``acc``)."""
        v = acc
        if self.scale is not None:
            v = (v.double() * self.scale.double() + self.bias.double()
                 ).to(acc.dtype)
        if self.residual is not None:
            v = v + self.residual.to(acc.dtype)
        return v if self.slope is None else _prelu(v, self.slope.to(v.dtype))


def _bf(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def _fma_chain(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """a (..., K) @ w (K, N) as an f32 FMA chain over K in order: each step
    the exact product plus the sum in f64, rounded to f32."""
    a64, w64 = a.double(), w.double()
    acc = torch.zeros(*a.shape[:-1], w.shape[1], device=a.device)
    for k in range(w.shape[0]):
        acc = (a64[..., k:k + 1] * w64[k] + acc.double()).float()
    return acc


def _core_inputs(y: torch.Tensor, wcore: Core, kind: str, dilation: int,
                 half: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """The core's inputs (N, H, W, taps * C) in the kernel's order (taps
    row by row, then channels) and its (taps * MID, MID) weights rounded to
    bf16; for asymmetric, half 0 is the 5x1 over y1 and half 1 the 1x5 over
    z.  Works on any channel count C (a mask too)."""
    n, h, w, _ = y.shape
    if kind == "asymmetric":
        wk = _bf(wcore[half].reshape(5 * MID, MID))
        if half == 0:
            yp = F.pad(y, (0, 0, 0, 0, 2, 2))
            return torch.cat([yp[:, k:k + h] for k in range(5)], -1), wk
        yp = F.pad(y, (0, 0, 2, 2))
        return torch.cat([yp[:, :, k:k + w] for k in range(5)], -1), wk
    d = int(dilation)
    yp = F.pad(y, (0, 0, d, d, d, d))
    return torch.cat([yp[:, ky * d:ky * d + h, kx * d:kx * d + w]
                      for ky in range(3) for kx in range(3)], -1), \
        _bf(wcore).reshape(-1, MID)


def chain_points(x: torch.Tensor, wp, s1, b1, a1, wcore: Core, s2, b2, a2,
                 we, s3, b3, ao, *, kind: str = "regular", dilation: int = 1
                 ) -> List[RoundingPoint]:
    """The bf16 kernel's rounding points in order (y1, [z,] y2, out), each
    fed by the chain's bf16 values of the points before it."""
    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    xf = x.float()
    pts: List[RoundingPoint] = []

    def add(*point) -> torch.Tensor:
        p = RoundingPoint(*point)
        p = p._replace(value=_bf(p.finish(_fma_chain(p.inputs, p.weights))))
        pts.append(p)
        return p.value

    y1 = add("y1", xf, _bf(wp), s1, b1, None, a1)
    inp, wk = _core_inputs(y1, wcore, kind, dilation)
    if kind == "asymmetric":
        z = add("z", inp, wk, None, None, None, None)
        inp, wk = _core_inputs(z, wcore, kind, dilation, half=1)
    y2 = add("y2", inp, wk, s2, b2, None, a2)
    pts.append(RoundingPoint("out", y2, _bf(we), s3, b3, xf, ao))
    return pts


def fused_bottleneck_chain(x: torch.Tensor, *args, kind: str = "regular",
                           dilation: int = 1) -> torch.Tensor:
    """The bf16 kernel's output, bit for bit, in plain torch: the
    arguments of :func:`fused_bottleneck` (bf16 ``x``; ``packed`` aside),
    every rounding point an f32 FMA chain (:func:`chain_points`).  Slow:
    one small op per input channel and tap."""
    out = chain_points(x, *args, kind=kind, dilation=dilation)[-1]
    return out.finish(_fma_chain(out.inputs, out.weights)).to(torch.bfloat16)


def _ambiguous(p: RoundingPoint) -> torch.Tensor:
    """Where the point's bf16 rounding is ambiguous: an f32 sum within the
    kernel's settle bound E = 2^-17 A + 2^-18 Q of the exact sum (A =
    sum |products|, Q = sum of |running sum| at the k16 steps) may round
    to other bits, or lies astride 0 where a PReLU follows.  Computed in
    f64; the f32 epilogue's own roundings widen the interval by 2^-22."""
    a, w = p.inputs.double(), p.weights.double()
    exact = a @ w
    big_a = a.abs() @ w.abs()
    part = torch.zeros_like(exact)
    q = torch.zeros_like(exact)
    for k0 in range(0, w.shape[0], 16):
        part = part + a[..., k0:k0 + 16] @ w[k0:k0 + 16]
        q = q + part.abs()
    e = ERR_ABS * big_a + ERR_ACC * q
    pre = p._replace(slope=None)
    ends = torch.stack([pre.finish(exact - e), pre.finish(exact + e)])
    lo, hi = ends.min(0).values, ends.max(0).values
    lo, hi = lo - 2 ** -22 * lo.abs(), hi + 2 ** -22 * hi.abs()
    astride = (lo < 0) & (hi > 0) if p.slope is not None else False
    if p.slope is not None:
        lo, hi = (_prelu(t, p.slope.double()) for t in (lo, hi))
    return astride | (lo.float().bfloat16() != hi.float().bfloat16())


def rounds_apart(x: torch.Tensor, *args, kind: str = "regular",
                 dilation: int = 1) -> Tuple[torch.Tensor, dict]:
    """Where and why the plain version (:func:`fused_bottleneck_ref`)
    rounds apart from the bf16 kernel (the chain, :func:`chain_points`),
    for the arguments of :func:`fused_bottleneck` (bf16 ``x``).

    At each rounding point before the output (y1, z, y2), an element whose
    bf16 value differs between the two is explained where the kernel's
    rounding of it is ambiguous (:func:`_ambiguous`, recomputed in f64) or
    where a value it reads already differs.  An output leaves the plain
    one by more than a few bf16 ulps only through a y2 of its pixel that
    differs: through the expansion and a residual that nearly cancels.

    Returns ((N, H, W) bool: the pixels with a y2 that differs; {point:
    {"apart": elements that differ, "unexplained": of those, the ones
    neither ambiguous nor fed by one that differs}})."""
    pts = chain_points(x, *args, kind=kind, dilation=dilation)
    plain = _plain_values(x, *args, kind=kind, dilation=dilation)
    counts = {}
    upstream = torch.zeros(*x.shape[:3], 1, dtype=torch.bool,
                           device=x.device)
    for p in pts[:-1]:
        apart = plain[p.name].permute(0, 2, 3, 1) != p.value
        lone = apart & ~_ambiguous(p) & ~upstream
        counts[p.name] = {"apart": int(apart.sum()),
                          "unexplained": int(lone.sum())}
        here = apart.any(-1, keepdim=True)
        if p.name == "y2":
            return here[..., 0], counts
        # the next point reads this one through the core's window: the
        # 3x3 (or the 5x1) over y1, the 1x5 over z
        feeds = _core_inputs(here.float(), args[4], kind, dilation,
                             half=int(p.name == "z"))[0]
        upstream = feeds.amax(-1, keepdim=True) > 0
    raise ValueError("no y2 rounding point")


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


def _check_param(t: torch.Tensor, shape: Tuple[int, ...], name: str,
                 device: torch.device) -> None:
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


_VEC_C, _VEC_M = (WIDTH,), (MID,)
_WP, _WE, _W33 = (WIDTH, MID), (MID, WIDTH), (3, 3, MID, MID)
_W51, _W15 = (5, 1, MID, MID), (1, 5, MID, MID)
_CORE_ASYM = (10 * MID * MID,)


def kernel_core(wcore: Core, kind: str) -> torch.Tensor:
    """The core taps as the kernel reads them: the (3, 3, 32, 32) HWIO
    tensor, or for asymmetric one flat buffer, the 5x1 taps then the 1x5
    taps (the views of one such buffer, as ``FusedBlock.wcore`` gives
    them, are passed as that buffer; other pairs are concatenated)."""
    if kind != "asymmetric":
        return wcore
    w51, w15 = wcore
    base = w51._base
    if (base is not None and base is w15._base and base.dim() == 1
            and base.numel() == w51.numel() + w15.numel()
            and w51.storage_offset() == base.storage_offset()
            and w15.storage_offset() == base.storage_offset() + w51.numel()
            and w51.is_contiguous() and w15.is_contiguous()):
        return base
    return torch.cat([w51.reshape(-1), w15.reshape(-1)])


def split_core(core: torch.Tensor, kind: str, mid: int = MID) -> Core:
    """:func:`kernel_core`'s buffer back as the wrapper's ``wcore``: the
    tensor itself, or the (5x1, 1x5) pair as views of it."""
    if kind != "asymmetric":
        return core
    m2 = mid * mid
    return (core[:5 * m2].view(5, 1, mid, mid),
            core[5 * m2:].view(1, 5, mid, mid))


def check_args(x: torch.Tensor, wp: torch.Tensor, s1: torch.Tensor,
               b1: torch.Tensor, a1: torch.Tensor, wcore: Core,
               s2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
               we: torch.Tensor, s3: torch.Tensor, b3: torch.Tensor,
               ao: torch.Tensor, *, kind: str = "regular",
               dilation: int = 1, packed: Optional[torch.Tensor] = None
               ) -> None:
    """Check a CUDA launch's arguments; raises ValueError.  Reads shapes,
    dtypes and devices only, so it runs on the fake tensors of an export
    too.  ``wcore`` as the wrapper takes it, or as :func:`kernel_core`
    gives it."""
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
    if int(dilation) < 1:
        _need(False, f"dilation must be >= 1, got {dilation}")
    dev = x.device
    if kind != "asymmetric":
        _check_param(wcore, _W33, "wcore", dev)
    elif isinstance(wcore, torch.Tensor):
        _check_param(wcore, _CORE_ASYM, "wcore", dev)
    else:
        _check_param(wcore[0], _W51, "wcore[0]", dev)
        _check_param(wcore[1], _W15, "wcore[1]", dev)
    for t, shape, name in ((wp, _WP, "wp"), (s1, _VEC_M, "s1"),
                           (b1, _VEC_M, "b1"), (a1, _VEC_M, "a1"),
                           (s2, _VEC_M, "s2"), (b2, _VEC_M, "b2"),
                           (a2, _VEC_M, "a2"), (we, _WE, "we"),
                           (s3, _VEC_C, "s3"), (b3, _VEC_C, "b3"),
                           (ao, _VEC_C, "ao")):
        _check_param(t, shape, name, dev)
    if bf16 and packed is not None and (
            packed.device != dev or packed.dtype != torch.bfloat16
            or packed.shape != (pack_elems(kind),)
            or not packed.is_contiguous()):
        _need(False, f"packed must be a contiguous bfloat16 tensor of "
                     f"shape ({pack_elems(kind)},) on {dev} (pack_weights"
                     f"), got {packed.dtype} {tuple(packed.shape)} on "
                     f"{packed.device}")


def launch_args(x: torch.Tensor, out: torch.Tensor,
                wp: torch.Tensor, s1: torch.Tensor, b1: torch.Tensor,
                a1: torch.Tensor, wcore: Core,
                s2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                we: torch.Tensor, s3: torch.Tensor, b3: torch.Tensor,
                ao: torch.Tensor, *, kind: str = "regular",
                dilation: int = 1, packed: Optional[torch.Tensor] = None
                ) -> Tuple[tuple, tuple]:
    """Check a CUDA launch's arguments (:func:`check_args`, and ``out``)
    and marshal them for the C launcher: (the launcher's argument tuple,
    on the current stream; the tensors that own memory it points to and
    were made here -- the core taps, the packed weights -- to keep alive
    while the tuple is used).  bf16 x needs the packed weights
    (:func:`pack_weights`); None packs them here."""
    check_args(x, wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao,
               kind=kind, dilation=dilation, packed=packed)
    _need(out.shape == x.shape and out.dtype == x.dtype
          and out.device == x.device and out.is_contiguous(),
          "out must be a contiguous tensor like x")
    bf16 = x.dtype == torch.bfloat16
    n, h, w, c = x.shape
    core = kernel_core(wcore, kind) if not isinstance(wcore, torch.Tensor) \
        else wcore
    ptrs = (wp.data_ptr(), s1.data_ptr(), b1.data_ptr(), a1.data_ptr(),
            core.data_ptr(), s2.data_ptr(), b2.data_ptr(), a2.data_ptr(),
            we.data_ptr(), s3.data_ptr(), b3.data_ptr(), ao.data_ptr())
    pack_ptr = 0
    if bf16:
        if packed is None:
            packed = pack_weights(wp, split_core(core, kind), we, kind=kind)
        pack_ptr = packed.data_ptr()
    args = (x.data_ptr(), out.data_ptr(), n, h, w, c, MID, *ptrs, pack_ptr,
            int(kind == "asymmetric"), int(dilation), int(bf16),
            _stream(x.device))
    return args, (core, packed)


def launch(x: torch.Tensor, wp: torch.Tensor, s1: torch.Tensor,
           b1: torch.Tensor, a1: torch.Tensor, core: torch.Tensor,
           s2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
           we: torch.Tensor, s3: torch.Tensor, b3: torch.Tensor,
           ao: torch.Tensor, packed: Optional[torch.Tensor], kind: str,
           dilation: int) -> torch.Tensor:
    """The kernel on CUDA tensors, the core taps as :func:`kernel_core`
    gives them: the CUDA implementation of the ``bugcar::fused_bottleneck``
    op (``ops/cuda/library.py``); raises if the build or the launch
    fails."""
    out = torch.empty_like(x, memory_format=torch.contiguous_format)
    with torch.cuda.device(x.device):
        args, _keep_alive = launch_args(
            x, out, wp, s1, b1, a1, core, s2, b2, a2, we, s3, b3, ao,
            kind=kind, dilation=dilation, packed=packed)
        lib = _build.library()
        err = lib.bugcar_fused_bottleneck(*args)
    if err != 0:
        smem = lib.bugcar_fused_bottleneck_smem_bytes(
            int(kind == "asymmetric"), x.shape[2], int(dilation),
            int(x.dtype == torch.bfloat16))
        _build.check(err, f"fused_bottleneck launch (x {tuple(x.shape)}, "
                          f"{smem} B of shared memory per block)")
    counted("fused_bottleneck")
    return out


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

    Returns (N, H, W, 128) in x's dtype, through the
    ``bugcar::fused_bottleneck`` op (``ops/cuda/library.py``): CPU tensors
    run the plain version, CUDA tensors launch the kernel or raise.  The
    arguments are checked before the op.
    """
    if kind not in KINDS:
        raise ValueError(f"unknown bottleneck kind {kind!r}")
    if x.device.type not in ("cpu", "cuda"):
        _need(False, f"x must be a CPU or CUDA tensor, got {x.device}")
    if x.device.type == "cuda":
        check_args(x, wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao,
                   kind=kind, dilation=dilation, packed=packed)
        if packed is None and x.dtype == torch.bfloat16:
            packed = pack_weights(wp, wcore, we, kind=kind)
    return _library.fused_bottleneck(
        x, wp, s1, b1, a1, kernel_core(wcore, kind), s2, b2, a2, we, s3, b3,
        ao, packed, kind, int(dilation))


__all__ = ["fused_bottleneck", "fused_bottleneck_ref", "fold_bn",
           "fused_bottleneck_chain", "chain_points", "rounds_apart",
           "RoundingPoint", "launch_args", "check_args", "launch",
           "kernel_core", "split_core", "pack_weights", "pack_elems",
           "plan", "KINDS"]
