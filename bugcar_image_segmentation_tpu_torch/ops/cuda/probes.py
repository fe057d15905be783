"""The Mosaic lowering probes' two kernels, their wrappers and their plain
PyTorch versions.

Port of the Pallas kernels of ``scripts/probe_mosaic.py``: ``try_probe``
and ``bf16_probe`` (strided slices and reshape-splits of an (R, W, C)
tensor) and ``k_halo`` (a zero-padded scratch and a shifted sum).  The
kernels are in ``csrc/strided_probes.cu``:

- :func:`strided_gather` — ``x[::sr, ::sw]`` as a contiguous tensor,
  ``(sr, sw)`` in {(2, 1), (1, 2), (2, 2)}, float32 or bfloat16.  The
  probes' reshape-splits compute the same values and take the same
  kernel: ``x.reshape(R, W // 2, 2, C)[:, :, 0]`` is ``x[:, ::2]`` and
  ``x.reshape(R // 2, 2, W, C)[:, 0]`` is ``x[::2]``.
- :func:`halo_add` — ``pad(x)[:R, :W] + pad(x)[2:, 2:]`` with a one-pixel
  zero border, float32 or bfloat16 (summed in f32, rounded once).

CPU tensors run the plain versions (:func:`strided_gather_reference`,
:func:`halo_add_reference`); CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import LAUNCHES
from . import build as _build

STRIDES = ((2, 1), (1, 2), (2, 2))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _need(cond: bool, what: str, msg: str) -> None:
    if not cond:
        raise ValueError(f"{what}: {msg}")


def _check(x: torch.Tensor, what: str) -> None:
    _need(x.dim() == 3, what, f"x must be (R, W, C), got {tuple(x.shape)}")
    _need(x.dtype in _DTYPES, what,
          f"x must be float32 or bfloat16, got {x.dtype}")


def strided_gather_reference(x: torch.Tensor, sr: int, sw: int
                             ) -> torch.Tensor:
    """The plain version: slicing plus ``.contiguous()``."""
    return x[::sr, ::sw].contiguous()


def halo_add_reference(x: torch.Tensor) -> torch.Tensor:
    """The plain version: ``F.pad`` with a one-pixel zero border plus a
    shifted add."""
    r, w = x.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return xp[:r, :w] + xp[2:, 2:]


def gathered_shape(x: torch.Tensor, sr: int, sw: int) -> tuple:
    """The shape of ``x[::sr, ::sw]``."""
    r, w, c = x.shape
    return (-(-r // sr), -(-w // sw), c)


def launch_key(x: torch.Tensor) -> str:
    """The ``LAUNCHES`` entry of a strided gather: one per instantiation
    the probes run (float32: ``try_probe``; bfloat16: ``bf16_probe``)."""
    return "strided_gather" + ("_bf16" if x.dtype == torch.bfloat16 else "")


def gather_args(x: torch.Tensor, out: torch.Tensor, sr: int, sw: int
                ) -> tuple:
    """Check a CUDA launch of the gather and marshal the C launcher's
    arguments (on the current stream)."""
    what = "strided_gather"
    _check(x, what)
    _need((sr, sw) in STRIDES, what, f"(sr, sw) must be one of {STRIDES}, "
                                     f"got {(sr, sw)}")
    _need(x.device.type == "cuda", what, f"x must be a CUDA tensor, got "
                                         f"{x.device}")
    _need(x.is_contiguous(), what, "x must be contiguous")
    r, w, c = x.shape
    _need(r * w * c > 0, what, f"x {tuple(x.shape)} is empty")
    _need(out.shape == gathered_shape(x, sr, sw) and out.dtype == x.dtype
          and out.device == x.device and out.is_contiguous(), what,
          "out must be a contiguous tensor like x[::sr, ::sw]")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return (x.data_ptr(), out.data_ptr(), r, w, c, sr, sw, _DTYPES[x.dtype],
            stream)


def halo_args(x: torch.Tensor, out: torch.Tensor) -> tuple:
    """Check a CUDA launch of the halo add and marshal its arguments."""
    what = "halo_add"
    _check(x, what)
    _need(x.device.type == "cuda", what, f"x must be a CUDA tensor, got "
                                         f"{x.device}")
    _need(x.is_contiguous(), what, "x must be contiguous")
    _need(out.shape == x.shape and out.dtype == x.dtype
          and out.device == x.device and out.is_contiguous(), what,
          "out must be a contiguous tensor like x")
    r, w, c = x.shape
    stream = torch.cuda.current_stream(x.device).cuda_stream
    return (x.data_ptr(), out.data_ptr(), r, w, c, _DTYPES[x.dtype], stream)


def strided_gather(x: torch.Tensor, sr: int, sw: int) -> torch.Tensor:
    """(R, W, C) → (⌈R / sr⌉, ⌈W / sw⌉, C): ``x[::sr, ::sw]``, contiguous.

    Also the probes' reshape-splits (the same elements; see the module
    docstring)."""
    if x.device.type == "cpu":
        _check(x, "strided_gather")
        return strided_gather_reference(x, sr, sw)
    _check(x, "strided_gather")
    out = torch.empty(gathered_shape(x, sr, sw), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        args = gather_args(x, out, sr, sw)
        err = _build.library().bugcar_strided_gather(*args)
    _build.check(err, f"strided_gather launch (x {tuple(x.shape)}, "
                      f"{(sr, sw)}, {x.dtype})")
    LAUNCHES[launch_key(x)] += 1
    return out


def halo_add(x: torch.Tensor) -> torch.Tensor:
    """(R, W, C) → (R, W, C): ``pad(x)[:R, :W] + pad(x)[2:, 2:]``, the
    border one pixel of zeros."""
    if x.device.type == "cpu":
        _check(x, "halo_add")
        return halo_add_reference(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        args = halo_args(x, out)
        err = _build.library().bugcar_halo_add(*args)
    _build.check(err, f"halo_add launch (x {tuple(x.shape)}, {x.dtype})")
    LAUNCHES["halo_add"] += 1
    return out


__all__ = ["strided_gather", "strided_gather_reference", "halo_add",
           "halo_add_reference", "gather_args", "halo_args", "launch_key",
           "gathered_shape", "STRIDES"]
