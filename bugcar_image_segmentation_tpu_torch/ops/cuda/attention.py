"""Blockwise attention as one CUDA kernel, its wrappers and its plain
PyTorch version.

Port of ``bugcar_image_segmentation_tpu/ops/pallas/attention.py``, with
the same functions and returns:

- :func:`flash_attention` on token-major operands q (B, H, Nq, d), k/v
  (B, H, Nkv, d);
- :func:`flash_attention_t` on channel-major operands q (B, H, d, Nq), k/v
  (B, H, d, Nkv);
- :func:`attention_reference`, the plain version: f32 einsum, softmax,
  einsum, cast back to q's dtype (:func:`attention_reference_t` is the
  same on channel-major operands).

Both compute softmax(q kᵀ / sqrt(d)) v with f32 accumulation, cast to q's
dtype.  One CUDA source (``csrc/flash_attention.cu``) serves both layouts
through two C entry points.  The wrappers check their operands and call
the ``bugcar::flash_attention[_t]`` ops (``library.py``): the plain
version for CPU tensors; CUDA tensors launch the kernel (:func:`launch`)
or raise.  The kernel has no
backward, so CUDA inputs that require grad raise.  The kernel takes head
dims 32 and 64 (SegFormer B0-B3) and contiguous float32 or bfloat16
operands; anything else raises.
"""

from __future__ import annotations

import ctypes
import math
from typing import Tuple

import torch

from . import LAUNCHES
from . import build as _build
from . import library as _library

HEAD_DIMS = (32, 64)


def attention_reference(q: torch.Tensor, k: torch.Tensor,
                        v: torch.Tensor) -> torch.Tensor:
    """Naive O(N²)-memory attention on (B, H, N, d): the plain version."""
    d = q.shape[-1]
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) / math.sqrt(d)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v.float()).to(q.dtype)


def attention_reference_t(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """:func:`attention_reference` on channel-major (B, H, d, N) operands;
    returns (B, H, d, Nq), contiguous."""
    out = attention_reference(q.transpose(-1, -2), k.transpose(-1, -2),
                              v.transpose(-1, -2))
    return out.transpose(-1, -2).contiguous()


def _need(cond: bool, name: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{name}: {msg}")


def check_args(name: str, q: torch.Tensor, k: torch.Tensor,
               v: torch.Tensor) -> None:
    """Check a CUDA launch's operands; raises ValueError.  Reads shapes,
    dtypes, devices and grad flags only, so it runs on the fake tensors of
    an export too."""
    channel_major = name == "flash_attention_t"
    # the messages are formatted only when a check fails (this runs on
    # every launch)
    if q.device.type != "cuda":
        _need(False, name, f"q must be a CUDA tensor, got {q.device}")
    _need(q.dim() == 4 and k.dim() == 4 and v.dim() == 4, name,
          "q, k, v must be 4-D")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        _need(False, name, "the kernel has no backward; inputs that require "
                           "grad take attention_reference (SegFormer does "
                           "in train mode)")
    if q.dtype not in (torch.float32, torch.bfloat16):
        _need(False, name, f"q must be float32 or bfloat16, got {q.dtype}")
    b, h = q.shape[0], q.shape[1]
    if channel_major:
        d, nq, nkv = q.shape[2], q.shape[3], k.shape[3]
        kv_shape = (b, h, d, nkv)
    else:
        nq, d, nkv = q.shape[2], q.shape[3], k.shape[2]
        kv_shape = (b, h, nkv, d)
    if d not in HEAD_DIMS:
        _need(False, name,
              f"head dim {d} is not one the kernel takes {HEAD_DIMS}")
    _need(nq >= 1 and nkv >= 1, name, "empty query or key sequence")
    if not 1 <= b * h <= 65535:
        _need(False, name, f"batch*heads {b * h} out of range")
    for t, what in ((k, "k"), (v, "v")):
        if t.shape != kv_shape:
            _need(False, name, f"{what} must have shape {kv_shape}, got "
                               f"{tuple(t.shape)}")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        if t.device != q.device or t.dtype != q.dtype:
            _need(False, name, f"{what} must be a {q.dtype} tensor on "
                               f"{q.device}")
        _need(t.is_contiguous(), name, f"{what} must be contiguous")


def launch_args(name: str, q: torch.Tensor, k: torch.Tensor,
                v: torch.Tensor, out: torch.Tensor) -> Tuple:
    """Check a CUDA launch's operands (:func:`check_args`, and ``out``)
    and marshal them for the C launcher ``bugcar_<name>`` (on the current
    stream)."""
    check_args(name, q, k, v)
    if out.device != q.device or out.dtype != q.dtype:
        _need(False, name, f"out must be a {q.dtype} tensor on {q.device}")
    _need(out.is_contiguous(), name, "out must be contiguous")
    _need(out.shape == q.shape, name, "out must have q's shape")
    b, h = q.shape[0], q.shape[1]
    if name == "flash_attention_t":
        d, nq, nkv = q.shape[2], q.shape[3], k.shape[3]
    else:
        nq, d, nkv = q.shape[2], q.shape[3], k.shape[2]
    stream = torch.cuda.current_stream(q.device).cuda_stream
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            b * h, nq, nkv, d, ctypes.c_float(1.0 / math.sqrt(d)),
            int(q.dtype == torch.bfloat16), stream)


def launch(name: str, q: torch.Tensor, k: torch.Tensor,
           v: torch.Tensor) -> torch.Tensor:
    """The kernel ``name`` on CUDA tensors: the CUDA implementation of the
    ``bugcar::<name>`` op (``ops/cuda/library.py``); raises if the build
    or the launch fails."""
    out = torch.empty_like(q, memory_format=torch.contiguous_format)
    with torch.cuda.device(q.device):
        args = launch_args(name, q, k, v, out)
        err = getattr(_build.library(), f"bugcar_{name}")(*args)
    _build.check(err, f"{name} launch (q {tuple(q.shape)}, "
                      f"k {tuple(k.shape)}, {q.dtype})")
    LAUNCHES[name] += 1
    return out


def _checked(name: str, q: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor) -> None:
    _need(q.device.type in ("cpu", "cuda"), name,
          f"q must be a CPU or CUDA tensor, got {q.device}")
    if q.device.type == "cuda":
        check_args(name, q, k, v)


def flash_attention(q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor) -> torch.Tensor:
    """Softmax(q kᵀ / sqrt(d)) v, blockwise, no (N, N) materialisation.

    Args:
      q: (B, H, Nq, d); k/v: (B, H, Nkv, d); float32 or bfloat16.

    Returns (B, H, Nq, d) in q's dtype, through the
    ``bugcar::flash_attention`` op (``ops/cuda/library.py``): CPU tensors
    run the plain version, CUDA tensors launch the kernel or raise.  The
    operands are checked before the op.
    """
    _checked("flash_attention", q, k, v)
    return _library.flash_attention(q, k, v)


def flash_attention_t(q: torch.Tensor, k: torch.Tensor,
                      v: torch.Tensor) -> torch.Tensor:
    """:func:`flash_attention` over channel-major operands, through the
    ``bugcar::flash_attention_t`` op.

    Args:
      q: (B, H, d, Nq); k/v: (B, H, d, Nkv); float32 or bfloat16.

    Returns (B, H, d, Nq) in q's dtype.
    """
    _checked("flash_attention_t", q, k, v)
    return _library.flash_attention_t(q, k, v)


__all__ = ["flash_attention", "flash_attention_t", "attention_reference",
           "attention_reference_t", "launch_args", "check_args", "launch",
           "HEAD_DIMS"]
