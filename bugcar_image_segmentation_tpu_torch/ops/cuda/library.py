"""The four serving kernels as ``torch.library`` custom ops.

A kernel launched through ctypes from a plain Python function cannot be
traced: ``torch.export`` runs the model on fake tensors, which have no
memory to point at.  Each serving kernel is therefore an operator of the
``bugcar`` namespace with three implementations:

- ``cpu``: the kernel's plain PyTorch version (``fused_bottleneck_ref``,
  ``attention_reference[_t]``, ``sepconv_reference``);
- ``cuda``: the ctypes launch of the hand-written kernel (``launch`` in
  each wrapper module), which builds the library at its first call, counts
  the launch in ``LAUNCHES`` and raises if the build or the launch fails;
- a fake: the output's shape, dtype and (contiguous) strides, which is all
  an export sees.

The ops and the wrappers that call them:

- ``bugcar::fused_bottleneck``, wrapped by ``bottleneck.fused_bottleneck``;
- ``bugcar::flash_attention`` and ``bugcar::flash_attention_t``, wrapped by
  ``attention.flash_attention[_t]``;
- ``bugcar::fused_sepconv``, wrapped by ``sepconv.fused_sepconv``.

The wrappers check their arguments, then call the op: it is the one route
to a kernel on the live path and inside an exported program, and a CUDA
tensor never falls back to the plain version.  Registration happens when
this module is imported (``ops/cuda/__init__.py`` imports it) and builds
nothing; a second import in one process reuses the registered ops.  An
op's signature takes tensors, ints, floats, bools and strings only: the
bottleneck's core taps come as one tensor (``bottleneck.kernel_core``) and
its kind as a string.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from . import attention as _att
from . import bottleneck as _bn
from . import sepconv as _sc

NAMESPACE = "bugcar"
OPS = ("fused_bottleneck", "flash_attention", "flash_attention_t",
       "fused_sepconv")


def _registered(name: str) -> bool:
    return torch._C._dispatch_has_kernel(f"{NAMESPACE}::{name}")


def _define(name: str, schema: str, cpu: Callable, cuda: Callable,
            fake: Callable) -> Callable:
    """The op ``bugcar::<name>`` (defined now unless it is already), as
    the callable of its default overload.  Plain ``torch.library``
    registrations: a call costs a few µs of dispatch, where
    ``torch.library.custom_op``'s autograd and aliasing layers cost ~15 µs
    more on the host."""
    qualname = f"{NAMESPACE}::{name}"
    if not _registered(name):
        torch.library.define(qualname, schema)
        torch.library.impl(qualname, "cpu", cpu)
        torch.library.impl(qualname, "cuda", cuda)
        torch.library.register_fake(qualname, fake)
    return getattr(getattr(torch.ops, NAMESPACE), name).default


# -- fused_bottleneck ---------------------------------------------------------

def _bottleneck_cpu(x: torch.Tensor, wp: torch.Tensor, s1: torch.Tensor,
                    b1: torch.Tensor, a1: torch.Tensor, core: torch.Tensor,
                    s2: torch.Tensor, b2: torch.Tensor, a2: torch.Tensor,
                    we: torch.Tensor, s3: torch.Tensor, b3: torch.Tensor,
                    ao: torch.Tensor, packed: Optional[torch.Tensor],
                    kind: str, dilation: int) -> torch.Tensor:
    return _bn.fused_bottleneck_ref(
        x, wp, s1, b1, a1, _bn.split_core(core, kind, wp.shape[1]), s2, b2,
        a2, we, s3, b3, ao, kind=kind, dilation=dilation)


def _bottleneck_fake(x, wp, s1, b1, a1, core, s2, b2, a2, we, s3, b3, ao,
                     packed, kind, dilation):
    return x.new_empty(x.shape)


fused_bottleneck = _define(
    "fused_bottleneck",
    "(Tensor x, Tensor wp, Tensor s1, Tensor b1, Tensor a1, Tensor core, "
    "Tensor s2, Tensor b2, Tensor a2, Tensor we, Tensor s3, Tensor b3, "
    "Tensor ao, Tensor? packed, str kind, int dilation) -> Tensor",
    _bottleneck_cpu, _bn.launch, _bottleneck_fake)


# -- flash_attention, flash_attention_t ---------------------------------------

def _attention_cpu(q: torch.Tensor, k: torch.Tensor,
                   v: torch.Tensor) -> torch.Tensor:
    return _att.attention_reference(q, k, v).contiguous()


def _attention_t_cpu(q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor) -> torch.Tensor:
    return _att.attention_reference_t(q, k, v)


def _attention_fake(q, k, v):
    return q.new_empty(q.shape)


_QKV = "(Tensor q, Tensor k, Tensor v) -> Tensor"
flash_attention = _define(
    "flash_attention", _QKV, _attention_cpu,
    lambda q, k, v: _att.launch("flash_attention", q, k, v), _attention_fake)
flash_attention_t = _define(
    "flash_attention_t", _QKV, _attention_t_cpu,
    lambda q, k, v: _att.launch("flash_attention_t", q, k, v),
    _attention_fake)


# -- fused_sepconv ------------------------------------------------------------

def _sepconv_cpu(x: torch.Tensor, wdw: torch.Tensor, s1: torch.Tensor,
                 b1: torch.Tensor, wpw: torch.Tensor, s2: torch.Tensor,
                 b2: torch.Tensor, strides: int,
                 act_out: bool) -> torch.Tensor:
    return _sc.sepconv_reference(x, wdw, s1, b1, wpw, s2, b2,
                                 strides=strides, act_out=act_out)


def _sepconv_fake(x, wdw, s1, b1, wpw, s2, b2, strides, act_out):
    n, h, w, _ = x.shape
    return x.new_empty((n, h // strides, w // strides, wpw.shape[-1]))


fused_sepconv = _define(
    "fused_sepconv",
    "(Tensor x, Tensor wdw, Tensor s1, Tensor b1, Tensor wpw, Tensor s2, "
    "Tensor b2, int strides, bool act_out) -> Tensor",
    _sepconv_cpu, _sc.launch, _sepconv_fake)


__all__ = ["fused_bottleneck", "flash_attention", "flash_attention_t",
           "fused_sepconv", "NAMESPACE", "OPS"]
