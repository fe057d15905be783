"""Dynamic W8A8 int8 matmul: the JAX package's ``_int8`` path.

Port of ``bugcar_image_segmentation_tpu/ops/quant.py``: symmetric
per-output-channel weight scales ``max|w[:, j]| / 127``, per-token
(row) activation scales ``max|x[i, :]| / 127``, both floored at 1e-12,
values ``clip(round(v / scale), -127, 127)`` as int8 (``torch.round``
rounds half to even, as ``jnp.round``), the product accumulated in
int32 (exact: |sum| <= 127^2 * K) and rescaled in f32.  The scales are
f32 divisions, not reciprocal multiplies, so the int8 values are the
JAX package's bit for bit.

The parameter tree stays the float one: a model quantizes its f32
weights once, at its first int8 product, where the JAX program quantizes
them at every call, to the same values.
Only shapes with K and N both at least :data:`MIN_K` / :data:`MIN_N` take
this path (``Int8Dense``'s gate); smaller products stay in float.

The int32 product, :func:`int8_mm`: on CPU tensors the plain version
(an int32 matmul); on CUDA tensors ``torch._int_mm`` (cuBLASLt's int8
tensor-core GEMM).  The JAX package computes it with ``lax.dot_general``
outside any Pallas kernel, so this is a library GEMM, not a port of a
TPU kernel.  ``_int_mm`` takes A (M, K) row-major and B (K, N)
column-major, with M > 16 and K, N multiples of 8: rows of A are padded
with zeros up to a multiple of 8 (and past 16) and sliced off, which is
exact; K or N off the rule raises.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

MIN_K = 512     # Int8Dense's gate: K and N both at least this
MIN_N = 512
_MM_ALIGN = 8   # torch._int_mm: K and N multiples of 8, M > 16
_MM_MIN_ROWS = 24   # the least multiple of 8 above 16


def gated(k: int, n: int) -> bool:
    """Whether a (K, N) product takes the int8 path (the JAX gate)."""
    return k >= MIN_K and n >= MIN_N


def _quantize(x: torch.Tensor, dim: int
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    x = x.float()
    scale = torch.clamp_min(x.abs().amax(dim, keepdim=True) / 127.0, 1e-12)
    return torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8), \
        scale


def quantize_weight_int8(w: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel int8 of an (in, out) kernel: ``(w_q int8 (in,
    out), scale f32 (out,))`` with ``w ≈ w_q * scale``.  ``w_q`` keeps
    ``w``'s memory layout, so the transpose of an (out, in) weight gives
    the column-major B that ``torch._int_mm`` takes."""
    w_q, scale = _quantize(w, 0)
    return w_q, scale[0]


def quantize_activation_int8(x: torch.Tensor
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-row (token) int8 of (..., k) activations: ``(x_q int8,
    scale f32 (..., 1))`` with ``x ≈ x_q * scale``."""
    return _quantize(x, -1)


def int8_mm_reference(x_q: torch.Tensor, w_q: torch.Tensor
                      ) -> torch.Tensor:
    """The plain version of :func:`int8_mm`: (M, K) @ (K, N) in int32."""
    return x_q.to(torch.int32) @ w_q.to(torch.int32)


def int8_mm(x_q: torch.Tensor, w_q: torch.Tensor) -> torch.Tensor:
    """(M, K) int8 @ (K, N) int8 → (M, N) int32, exact: the plain version
    for CPU tensors, ``torch._int_mm`` for CUDA tensors."""
    if x_q.dtype != torch.int8 or w_q.dtype != torch.int8:
        raise ValueError(f"int8_mm takes int8 operands, got {x_q.dtype} "
                         f"and {w_q.dtype}")
    if not x_q.is_cuda:
        return int8_mm_reference(x_q, w_q)
    (m, k), n = x_q.shape, w_q.shape[1]
    if k % _MM_ALIGN or n % _MM_ALIGN:
        raise ValueError(f"torch._int_mm needs K and N multiples of "
                         f"{_MM_ALIGN}; got K={k}, N={n}")
    rows = max(-(-m // _MM_ALIGN) * _MM_ALIGN, _MM_MIN_ROWS)
    a = F.pad(x_q, (0, 0, 0, rows - m)) if rows != m else x_q.contiguous()
    if w_q.stride(0) != 1:          # B column-major
        w_q = w_q.t().contiguous().t()
    out = torch._int_mm(a, w_q)
    return out[:m] if rows != m else out


def int8_linear(x: torch.Tensor, w_q: torch.Tensor, w_s: torch.Tensor
                ) -> torch.Tensor:
    """:func:`int8_matmul` with the weight already quantized
    (:func:`quantize_weight_int8`)."""
    x_q, x_s = quantize_activation_int8(x)
    acc = int8_mm(x_q.reshape(-1, x.shape[-1]), w_q)
    return acc.float().reshape(x.shape[:-1] + (w_q.shape[1],)) * x_s * w_s


def int8_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` by dynamic W8A8: ``x`` (..., K) float, ``w`` (K, N)
    float → (..., N) f32, rescaled ``acc * x_s * w_s`` as the JAX
    ``int8_matmul``."""
    return int8_linear(x, *quantize_weight_int8(w))


__all__ = ["MIN_K", "MIN_N", "gated", "quantize_weight_int8",
           "quantize_activation_int8", "int8_mm", "int8_mm_reference",
           "int8_linear", "int8_matmul"]
