"""The Mosaic lowering probes' two kernels, their launch plans, their
wrappers and their plain PyTorch versions.

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

Two routes on the card, chosen by one rule (:func:`tma_refusal`): a
tensor whose pixel (``C * itemsize`` bytes) is a multiple of 16 and
whose base pointers are 16-byte aligned takes the TMA kernels
(``strided_gather_tma``, ``halo_add_tma``); any other takes the SIMT
kernels (TMA cannot address it).  :func:`tma_plan` and :func:`halo_plan`
give the route and, for TMA, the tensor maps, boxes and grid that the
wrapper passes to the C launcher as they are.  ``LAUNCHES`` counts every
launch of each function; ``ROUTES`` counts them by route.

CPU tensors run the plain versions (:func:`strided_gather_reference`,
:func:`halo_add_reference`); CUDA tensors launch a kernel or raise.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from . import ROUTES, counted
from . import build as _build

STRIDES = ((2, 1), (1, 2), (2, 2))
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ITEM = {torch.float32: 4, torch.bfloat16: 2}

SMS = 132                 # H100 SXM: the plan aims at one wave of CTAs
MAX_BOX_BYTES = 16384     # one box in shared memory (kMaxBoxBytes)
BOX_MAX = 256             # TMA: elements a box dimension spans
TMA_ALIGN = 16            # TMA: bytes of bases, strides and the inner box
# (columns, rows) by which the halo add's two loads shift the output box
HALO_SHIFTS = ((-1, -1), (1, 1))


@dataclass(frozen=True)
class TensorMap:
    """One TMA tensor map, dimensions innermost first (C, W, R)."""
    dims: Tuple[int, int, int]      # elements
    strides: Tuple[int, int]        # bytes between neighbours in dims 1, 2
    box: Tuple[int, int, int]       # elements a box spans
    elem: Tuple[int, int, int] = (1, 1, 1)   # traversal strides


@dataclass(frozen=True)
class Plan:
    """How one launch runs: ``route`` "tma" or "simt" (``reason`` says
    why not TMA); for TMA the map the loads read (x) and the one the store
    writes (out), the number of output boxes along C, W and R, and the
    grid (one CTA a box)."""
    route: str
    reason: str = ""
    load: Optional[TensorMap] = None
    store: Optional[TensorMap] = None
    tiles: Optional[Tuple[int, int, int]] = None
    grid: Optional[int] = None

    def packed(self) -> ctypes.Array:
        """The C launcher's plan: int64 values in ``PlanSlot`` order."""
        if self.route != "tma":
            raise ValueError(f"a {self.route} plan has no TMA slots")
        vals = (*self.load.dims, *self.load.strides, *self.load.box,
                *self.load.elem, *self.store.dims, *self.store.strides,
                *self.store.box, *self.tiles, self.grid)
        return (ctypes.c_longlong * len(vals))(*vals)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def tma_refusal(c: int, item: int, aligned: bool = True) -> str:
    """The route rule: "" when TMA can address an (R, W, C) tensor of
    ``item``-byte elements, else why not."""
    if (c * item) % TMA_ALIGN:
        return (f"a pixel is {c * item} bytes (C * itemsize), not a "
                f"multiple of {TMA_ALIGN}")
    if not aligned:
        return f"a base pointer is not {TMA_ALIGN}-byte aligned"
    return ""


def _boxes(ro: int, wo: int, c: int, item: int, sr: int, sw: int
           ) -> Tuple[int, int, int]:
    """(bc, bw, br): an output box of whole pixels, at most
    MAX_BOX_BYTES, sized so that the (ro, wo, c) output spreads over the
    SMs in one wave (more waves only when a box is full)."""
    bc = min(c, BOX_MAX)
    fits = MAX_BOX_BYTES // (bc * item)
    want = max(1, min(fits, _cdiv(ro * wo * _cdiv(c, bc), SMS)))
    bw = min(wo, want, BOX_MAX // sw)
    br = min(ro, max(1, want // bw), BOX_MAX // sr)
    return bc, bw, br


@functools.lru_cache(maxsize=256)
def _plan(shape: Tuple[int, int, int], dtype: torch.dtype, sr: int, sw: int,
          aligned: bool) -> Plan:
    r, w, c = shape
    item = _ITEM[dtype]
    reason = tma_refusal(c, item, aligned)
    if reason:
        return Plan("simt", reason)
    ro, wo = _cdiv(r, sr), _cdiv(w, sw)
    bc, bw, br = _boxes(ro, wo, c, item, sr, sw)
    run = c * item
    load = TensorMap((c, w, r), (run, run * w), (bc, bw * sw, br * sr),
                     (1, sw, sr))
    store = TensorMap((c, wo, ro), (run, run * wo), (bc, bw, br))
    tiles = (_cdiv(c, bc), _cdiv(wo, bw), _cdiv(ro, br))
    return Plan("tma", "", load, store, tiles, tiles[0] * tiles[1] * tiles[2])


def tma_plan(shape, dtype: torch.dtype, strides: Tuple[int, int],
             aligned: bool = True) -> Plan:
    """The strided gather's plan for an (R, W, C) ``shape``: x's map with
    traversal strides (1, sw, sr) (a load box spans ``bw * sw`` columns and
    ``br * sr`` rows of x and lands as a dense ``bw x br`` box), loaded at
    (c0, w0 * sw, r0 * sr) for the output box at (c0, w0, r0), and out's
    map for the store."""
    sr, sw = strides
    return _plan(tuple(int(v) for v in shape), dtype, int(sr), int(sw),
                 bool(aligned))


def halo_plan(shape, dtype: torch.dtype, aligned: bool = True) -> Plan:
    """The halo add's plan: x's map loaded twice for the output box at
    (c0, w0, r0), at (c0, w0 + dw, r0 + dr) for each (dw, dr) of
    HALO_SHIFTS (zeros outside x), and out's map for the store."""
    return _plan(tuple(int(v) for v in shape), dtype, 1, 1, bool(aligned))


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


def _aligned(*ts: torch.Tensor) -> bool:
    return all(t.data_ptr() % TMA_ALIGN == 0 for t in ts)


def _routed(plan: Plan, route: Optional[str], what: str) -> str:
    """The route a launch takes: the plan's, or ``route`` where a caller
    names one (a measurement of the other route at the same shape); TMA
    only where the plan allows it."""
    if route is None:
        return plan.route
    _need(route in ("tma", "simt"), what, f"route must be 'tma' or 'simt', "
                                          f"got {route!r}")
    _need(route == "simt" or plan.route == "tma", what,
          f"the TMA route cannot take this tensor: {plan.reason}")
    return route


def gather_args(x: torch.Tensor, out: torch.Tensor, sr: int, sw: int,
                route: Optional[str] = None) -> Tuple[str, str, tuple]:
    """Check a CUDA launch of the gather, plan it and marshal the C
    launcher's arguments on the current stream: (route, launcher name,
    arguments)."""
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
    args = (x.data_ptr(), out.data_ptr(), r, w, c, sr, sw, _DTYPES[x.dtype])
    plan = tma_plan(x.shape, x.dtype, (sr, sw), _aligned(x, out))
    route = _routed(plan, route, what)
    if route == "tma":
        return route, "bugcar_strided_gather_tma", (*args, plan.packed(),
                                                    stream)
    return route, "bugcar_strided_gather", (*args, stream)


def halo_args(x: torch.Tensor, out: torch.Tensor,
              route: Optional[str] = None) -> Tuple[str, str, tuple]:
    """Check a CUDA launch of the halo add, plan it and marshal its
    arguments: (route, launcher name, arguments)."""
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
    args = (x.data_ptr(), out.data_ptr(), r, w, c, _DTYPES[x.dtype])
    plan = halo_plan(x.shape, x.dtype, _aligned(x, out))
    route = _routed(plan, route, what)
    if route == "tma":
        return route, "bugcar_halo_add_tma", (*args, plan.packed(), stream)
    return route, "bugcar_halo_add", (*args, stream)


def _launch(key: str, marshalled: Tuple[str, str, tuple], what: str
            ) -> None:
    route, name, args = marshalled
    _build.check(getattr(_build.library(), name)(*args), what)
    counted(key)
    ROUTES[key][route] += 1


def strided_gather(x: torch.Tensor, sr: int, sw: int) -> torch.Tensor:
    """(R, W, C) → (⌈R / sr⌉, ⌈W / sw⌉, C): ``x[::sr, ::sw]``, contiguous.

    Also the probes' reshape-splits (the same elements; see the module
    docstring)."""
    _check(x, "strided_gather")
    if x.device.type == "cpu":
        return strided_gather_reference(x, sr, sw)
    out = torch.empty(gathered_shape(x, sr, sw), dtype=x.dtype,
                      device=x.device)
    with torch.cuda.device(x.device):
        _launch(launch_key(x), gather_args(x, out, sr, sw),
                f"strided_gather launch (x {tuple(x.shape)}, {(sr, sw)}, "
                f"{x.dtype})")
    return out


def halo_add(x: torch.Tensor) -> torch.Tensor:
    """(R, W, C) → (R, W, C): ``pad(x)[:R, :W] + pad(x)[2:, 2:]``, the
    border one pixel of zeros."""
    _check(x, "halo_add")
    if x.device.type == "cpu":
        return halo_add_reference(x)
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        _launch("halo_add", halo_args(x, out),
                f"halo_add launch (x {tuple(x.shape)}, {x.dtype})")
    return out


__all__ = ["strided_gather", "strided_gather_reference", "halo_add",
           "halo_add_reference", "gather_args", "halo_args", "launch_key",
           "gathered_shape", "tma_plan", "halo_plan", "tma_refusal", "Plan",
           "TensorMap", "STRIDES", "HALO_SHIFTS"]
