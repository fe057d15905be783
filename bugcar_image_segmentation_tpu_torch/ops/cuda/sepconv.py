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

:func:`fused_sepconv` checks its arguments and calls the
``bugcar::fused_sepconv`` op (``library.py``), which launches the kernel
for CUDA tensors (:func:`launch`) and runs :func:`sepconv_reference` for
CPU tensors; there is no other fallback.

:func:`plan` decides how a launch is cut -- pixel tile, thread block
cluster, weight ring -- from (H, W, C, F, stride) alone, never from the
batch, so a frame's result does not depend on the batch it runs in; the
kernel checks the plan and refuses one it cannot run.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Tuple

import torch
import torch.nn.functional as F

from . import LAUNCHES
from . import build as _build
from . import library as _library
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


# The device type launch_args takes, and the stream it launches on; the
# CPU tests replace both to read the arguments it marshals.
_CARD = "cuda"


def _stream(dev: torch.device) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# The card and the kernel's tiles (csrc/fused_sepconv.cu mirrors them).
SMEM_CTA = 232448         # dynamic shared memory one CTA may use
SMEM_SM = 233472          # shared memory of one SM, 1 KB of it per CTA reserved
TILE_COLS = 8             # output columns of a pixel tile
TILE_F = 64               # output channels of an F tile
STEP_F = 2 * TILE_F       # output channels of a pointwise step
K_STEP = 64               # input channels of a weight chunk
DW_CHUNK = 32             # channels of a depthwise window chunk
WIN_BUFS = 3              # window chunks in flight
CLUSTERS = tuple(range(1, 9))
# Clusters of G CTAs the card holds at once with 1 or 2 CTAs an SM, as
# ``scripts/torch_sepconv_plans.py`` reads them on an H100 SXM (132 SMs;
# cudaOccupancyMaxActiveClusters): whole clusters must fit in one GPC, so
# G = 4 gets 30 (120 SMs), G = 3 39 (117 SMs).
MAX_CLUSTERS = {1: (132, 66, 39, 30, 22, 17, 15, 15),
                2: (264, 132, 79, 62, 47, 39, 32, 30)}
# A 32-channel depthwise chunk of a tile costs about DW_COST pointwise
# steps (64 pixels x 64 K x 128 F), DW_COST_S2 at stride 2 (its window is
# 2.9x larger): the cost model's only constants, set so that its plans
# are the fastest ``scripts/torch_sepconv_plans.py`` measures, or within
# 2 % of them, at every site of the path.
DW_COST = 0.25
DW_COST_S2 = 0.5


@dataclass(frozen=True)
class Plan:
    """How one launch is cut.  ``channel_slices[r]`` are the y1 channels
    CTA ``r`` of a cluster computes, ``f_tiles[r]`` the range of 64-wide
    F tiles it multiplies; both follow from ``cluster`` by the formula the
    kernel uses."""
    tile_rows: int
    tile_cols: int
    tiles_h: int
    tiles_w: int
    cluster: int
    stages: int
    smem_bytes: int
    channel_slices: Tuple[Tuple[int, int], ...]
    f_tiles: Tuple[Tuple[int, int], ...]

    def grid(self, n: int) -> Tuple[int, int, int]:
        """The launch grid for a batch of n; the cluster spans x."""
        return (self.cluster * self.tiles_w, self.tiles_h, n)


def _round_up(a: int, b: int) -> int:
    return -(-a // b) * b


def smem_bytes(tile_rows: int, c: int, stride: int, stages: int) -> int:
    """Dynamic shared memory of a bf16 launch: y1 (tile pixels x C rounded
    up to 64), three window buffers of four 8-channel planes (each plane
    rounded up to 128 bytes, + 32), their f32 filter chunks, the weight
    ring (64 x 128 bf16 a stage) and its four mbarriers."""
    rows = tile_rows + 2 if stride == 1 else 2 * tile_rows + 1
    cols = TILE_COLS + 2 if stride == 1 else 2 * TILE_COLS + 1
    y1 = tile_rows * TILE_COLS * _round_up(c, K_STEP) * 2
    plane = _round_up(rows * cols * 16, 128) + 32
    win = _round_up(WIN_BUFS * (DW_CHUNK // 8) * plane, 128)
    ring = _round_up(y1 + win + WIN_BUFS * 11 * DW_CHUNK * 4, 1024)
    return ring + stages * K_STEP * STEP_F * 2 + 32


@functools.lru_cache(maxsize=None)
def plan(h: int, w: int, c: int, f: int, stride: int) -> Plan:
    """The launch plan of one site shape: a function of (H, W, C, F,
    stride) only.

    Tile 8x8 output pixels, or 4x8 where y1 of 64 pixels does not fit
    beside the window and the ring; the deepest weight ring (4, 3 or 2
    stages) that still lets two CTAs share an SM, else the deepest that
    fits one.  The cluster size G (CTAs sharing a pixel tile,
    each computing C/G of the depthwise and nft/G of the F tiles) minimises
    waves x per-CTA work for one image, counted in pointwise steps, the
    depthwise weighted by ``DW_COST``; ties go to the smaller G.  Raises
    ValueError for a shape the kernel does not take."""
    _need(stride in (1, 2), f"strides must be 1 or 2, got {stride}")
    _need(min(h, w, c, f) >= 1, f"empty shape {(h, w, c, f)}")
    _need(stride == 1 or (h % 2 == 0 and w % 2 == 0),
          f"strides=2 needs even H, W; got {(h, w)}")
    ho, wo = h // stride, w // stride
    # two CTAs an SM hide each other's latency: take the deepest ring that
    # lets two share an SM, else the deepest that fits one
    fits = [(per_sm, rows, stages) for rows in (8, 4)
            for stages in (4, 3, 2) for per_sm in (2, 1)
            if smem_bytes(rows, c, stride, stages) <= min(
                SMEM_CTA, SMEM_SM // per_sm - 1024)]
    if not fits:
        raise ValueError(f"fused_sepconv: C = {c} is too wide for the y1 "
                         f"tile in shared memory (over {SMEM_CTA} bytes)")
    per_sm, rows, stages = max(fits, key=lambda t: (t[1] == 8, t[0], t[2]))
    smem = smem_bytes(rows, c, stride, stages)
    tiles_h, tiles_w = -(-ho // rows), -(-wo // TILE_COLS)
    _need(tiles_h <= 65535, f"output height {ho} needs too many tiles")
    nft, groups, nk = -(-f // TILE_F), -(-c // 8), -(-c // K_STEP)
    dw = DW_COST if stride == 1 else DW_COST_S2

    def cost(g: int) -> float:
        waves = -(-tiles_h * tiles_w // MAX_CLUSTERS[per_sm][g - 1])
        chunks = -(-(-(-groups // g) * 8) // DW_CHUNK)
        return waves * (-(-(-(-nft // g)) // 2) * nk + dw * chunks)

    cluster = min((g for g in CLUSTERS if g <= min(nft, groups)),
                  key=lambda g: (cost(g), g))
    slices = tuple((8 * (r * groups // cluster),
                    min(c, 8 * ((r + 1) * groups // cluster)))
                   for r in range(cluster))
    ftiles = tuple((r * nft // cluster, (r + 1) * nft // cluster)
                   for r in range(cluster))
    return Plan(rows, TILE_COLS, tiles_h, tiles_w, cluster, stages, smem,
                slices, ftiles)


def _check_param(t: torch.Tensor, shape, name: str, device: torch.device,
                 dtype: torch.dtype = torch.float32) -> None:
    # the messages are formatted only for a tensor that fails: this runs
    # for six tensors a launch, 55 launches an Xception frame
    if (t.device != device or t.dtype != dtype or t.shape != tuple(shape)
            or not t.is_contiguous()):
        _need(t.device == device, f"{name} is on {t.device}, x on {device}")
        _need(t.dtype == dtype, f"{name} must be {dtype}, got {t.dtype}")
        _need(tuple(t.shape) == tuple(shape),
              f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        _need(t.is_contiguous(), f"{name} must be contiguous")


def check_args(x: torch.Tensor, wdw: torch.Tensor, s1: torch.Tensor,
               b1: torch.Tensor, wpw: torch.Tensor, s2: torch.Tensor,
               b2: torch.Tensor, *, strides: int = 1) -> None:
    """Check a CUDA launch's operands (``wpw`` in x's dtype); raises
    ValueError.  Reads shapes, dtypes, devices and grad flags only, so it
    runs on the fake tensors of an export too."""
    _check_stride(x, strides)
    if x.device.type != _CARD:
        _need(False, f"x must be a CUDA tensor, got {x.device}")
    if any(t.requires_grad for t in (x, wdw, s1, b1, wpw, s2, b2)):
        _need(False, "the kernel has no backward; inputs that require grad "
                     "take the plain convs (Xception does in train mode)")
    if x.dim() != 4:
        _need(False, f"x must be (N, H, W, C), got {tuple(x.shape)}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        _need(False, f"x must be float32 or bfloat16, got {x.dtype}")
    _need(x.is_contiguous(), "x must be contiguous (NHWC memory)")
    n, h, w, c = x.shape
    f = wpw.shape[-1]
    if min(n, h, w, c, f) < 1:
        _need(False, f"empty operand: x {tuple(x.shape)}, wpw "
                     f"{tuple(wpw.shape)}")
    if n > 65535:
        _need(False, f"batch {n} exceeds the grid's 65535")
    dev = x.device
    for t, shape, name, dtype in (
            (wdw, (3, 3, 1, c), "wdw", torch.float32),
            (s1, (c,), "s1", torch.float32), (b1, (c,), "b1", torch.float32),
            (wpw, (c, f), "wpw", x.dtype), (s2, (f,), "s2", torch.float32),
            (b2, (f,), "b2", torch.float32)):
        _check_param(t, shape, name, dev, dtype)
    plan(h, w, c, f, strides)


def launch_args(x: torch.Tensor, out: torch.Tensor, wdw: torch.Tensor,
                s1: torch.Tensor, b1: torch.Tensor, wpw: torch.Tensor,
                s2: torch.Tensor, b2: torch.Tensor, *, strides: int = 1,
                act_out: bool = True) -> tuple:
    """Check a CUDA launch's arguments (:func:`check_args`, and ``out``)
    and marshal them, with the launch :func:`plan`, for the C launcher
    ``bugcar_fused_sepconv`` (on the current stream); ``wpw`` in x's
    dtype."""
    check_args(x, wdw, s1, b1, wpw, s2, b2, strides=strides)
    n, h, w, c = x.shape
    f = wpw.shape[-1]
    ho, wo = h // strides, w // strides
    if not (out.shape == (n, ho, wo, f) and out.dtype == x.dtype
            and out.device == x.device and out.is_contiguous()):
        _need(False, f"out must be a contiguous {x.dtype} (N, H/s, W/s, F) "
                     f"tensor")
    pl = plan(h, w, c, f, strides)
    stream = _stream(x.device)
    return (x.data_ptr(), wdw.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            wpw.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            n, h, w, c, f, int(strides), int(bool(act_out)),
            int(x.dtype == torch.bfloat16), pl.tile_rows, pl.cluster,
            pl.stages, stream)


def launch(x: torch.Tensor, wdw: torch.Tensor, s1: torch.Tensor,
           b1: torch.Tensor, wpw: torch.Tensor, s2: torch.Tensor,
           b2: torch.Tensor, strides: int, act_out: bool) -> torch.Tensor:
    """The kernel on CUDA tensors (``wpw`` in x's dtype): the CUDA
    implementation of the ``bugcar::fused_sepconv`` op
    (``ops/cuda/library.py``); raises if the build or the launch fails."""
    n, h, w, _ = x.shape
    out = torch.empty((n, h // strides, w // strides, wpw.shape[-1]),
                      dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        args = launch_args(x, out, wdw, s1, b1, wpw, s2, b2,
                           strides=strides, act_out=act_out)
        err = _build.library().bugcar_fused_sepconv(*args)
    _build.check(err, f"fused_sepconv launch (x {tuple(x.shape)}, F "
                      f"{wpw.shape[-1]}, stride {strides}, {x.dtype})")
    LAUNCHES["fused_sepconv"] += 1
    return out


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

    Returns (N, H/strides, W/strides, F) in x's dtype, through the
    ``bugcar::fused_sepconv`` op (``ops/cuda/library.py``): CPU tensors run
    the plain version, CUDA tensors launch the kernel or raise.  The
    arguments are checked before the op.
    """
    _check_stride(x, strides)
    if x.device.type not in ("cpu", "cuda"):
        _need(False, f"x must be a CPU or CUDA tensor, got {x.device}")
    if wpw.dtype == torch.float32 and x.dtype != torch.float32:
        wpw = wpw.to(x.dtype)   # rounded where the kernel would round it
    if torch.compiler.is_exporting():
        # the fake CUDA tensors of an export may carry other strides than
        # the card gives the same activation (a cuDNN conv's layout): the
        # program asks for the NHWC memory the kernel reads
        x = x.contiguous()
    if x.device.type == "cuda":
        check_args(x, wdw, s1, b1, wpw, s2, b2, strides=strides)
    return _library.fused_sepconv(x, wdw, s1, b1, wpw, s2, b2, int(strides),
                                  bool(act_out))


__all__ = ["fused_sepconv", "sepconv_reference", "fold_bn", "launch_args",
           "check_args", "launch",
           "plan", "Plan", "smem_bytes"]
