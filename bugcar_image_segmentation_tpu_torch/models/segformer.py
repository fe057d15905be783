"""SegFormer (MiT backbone + all-MLP head) in PyTorch.

Port of ``bugcar_image_segmentation_tpu/models/segformer.py`` (BASELINE
config 5; Xie et al., 2021), its textbook NHWC forward: four stages of
overlapped patch embedding, efficient self-attention with spatial
reduction of K/V and Mix-FFN, fused by an all-MLP decode head at 1/4
resolution.  The JAX package's transposed (C, pixels) twins of the same
math are not ported; tests hold this forward against both JAX layouts.

The module tree follows the Flax variable tree (``stage0_block1.attn.q``
↔ ``params/stage0_block1/attn/q``; Dense ``kernel`` (in, out) ↔
``weight`` (out, in); conv ``kernel`` HWIO ↔ ``weight`` OIHW; LayerNorm
and BatchNorm keep ``scale``/``bias``, BatchNorm's running ``mean``/
``var`` are buffers), so ``convert/flax_segformer.py`` maps a Flax tree
onto it one leaf at a time.

Numerics, as the Flax module: LayerNorm (eps 1e-6) and the head's
BatchNorm (eps 1e-5, running statistics) compute in f32 from f32
parameters and cast to the activation dtype; Dense and conv weights are
used in the activation dtype (:meth:`SegFormer.to_compute_dtype` casts
them once); GELU is the tanh form unless ``torch_compat``; the head
resizes the bf16 projections and the final ×4 runs in f32.

``quant`` (engine suffix ``_int8``) runs every Dense whose K and N clear
the W8A8 gate (``ops/quant.py``: both >= 512; at B2 stage 3's q, k, v,
proj, fc1 and fc2) on int8 with int32 sums, rescaled ``acc * w_s * x_s``
as the JAX transposed Dense (``models/chw.py::ChwDense``) that the JAX
engine runs.  ``quant`` and ``head_cascade`` (``_hc``) take the JAX
engine's folded head (``SegFormer(chw_head=True)``): the bias-free fuse
conv composed into each stage's ``linear_c`` in f32 (stage s takes rows
(3-s)*dd:(4-s)*dd of the fuse kernel, which is in ``concat(parts[::-1])``
order), the folded product quantized where the stage width and the
decoder width both clear the gate, and the four decoder-width parts
summed at 1/4 resolution — directly, or (``head_cascade``) from the
smallest stage up, ``acc = p_s + up(acc)``, as the JAX cascade does.
The plain and ``_q`` engines keep the textbook head (linear_c, upsample,
concat, fuse).

Attention runs through the CUDA kernel of ``ops/cuda/attention.py``
(the plain version on CPU tensors, or with ``xla_attention``), in the
layout in which the head split is free: with one head (stage 0) the
Linear's (N, L, C) output is already (N, 1, L, d), token-major; with
several heads, q/k/v come out of a transposed product as (N, C, L) =
(N, H, d, L), channel-major, and the output feeds the projection the same
way, so no head split or merge is ever copied.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.cuda.attention import (attention_reference,
                                  attention_reference_t, flash_attention,
                                  flash_attention_t)
from ..ops import quant as q8
from ..ops.resize import upsample_bilinear
from .layers import BatchNorm, Conv, _cast

LN_EPS = 1e-6      # flax.linen.LayerNorm's default
BN_EPS = 1e-5      # the head's fuse_bn

# MiT backbone size presets (Xie et al., 2021, table 1).  All share the
# head counts (1, 2, 5, 8) and spatial-reduction ratios (8, 4, 2, 1).
SEGFORMER_PRESETS = {
    "b0": dict(widths=(32, 64, 160, 256), depths=(2, 2, 2, 2),
               decoder_dim=256),
    "b1": dict(widths=(64, 128, 320, 512), depths=(2, 2, 2, 2),
               decoder_dim=256),
    "b2": dict(widths=(64, 128, 320, 512), depths=(3, 4, 6, 3),
               decoder_dim=768),
    "b3": dict(widths=(64, 128, 320, 512), depths=(3, 4, 18, 3),
               decoder_dim=768),
}


class Dense(nn.Module):
    """``nn.Dense`` over the last axis (``kernel`` (in, out) ↔ ``weight``
    (out, in)).  ``quant``: the W8A8 int8 product where K and N clear the
    gate (:attr:`int8`); its int8 weights come from the f32 weight at the
    first call, which therefore stays f32."""

    def __init__(self, cin: int, cout: int, quant: bool = False):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin))
        self.bias = nn.Parameter(torch.zeros(cout))
        self.int8 = quant and q8.gated(cin, cout)
        self._w8 = None

    def clear(self) -> None:
        """Forget the int8 weights (after new parameters or a move)."""
        self._w8 = None

    def _int8(self, x: torch.Tensor) -> torch.Tensor:
        """(..., in) → (..., out) in x's dtype: per-token int8 activations,
        int32 sums, ``acc * w_s * x_s + b`` in f32 (ChwDense's order)."""
        if self._w8 is None:
            self._w8 = q8.quantize_weight_int8(self.weight.float().t())
        w_q, w_s = self._w8
        x_q, x_s = q8.quantize_activation_int8(x)
        acc = q8.int8_mm(x_q.reshape(-1, x.shape[-1]), w_q)
        acc = acc.view(x.shape[:-1] + (w_q.shape[1],))
        return (acc.float() * w_s * x_s + self.bias.float()).to(x.dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.int8:
            return self._int8(x)
        return F.linear(x, _cast(self.weight, x), _cast(self.bias, x))

    def forward_t(self, x: torch.Tensor) -> torch.Tensor:
        """(N, L, in) → (N, out, L): the same product, channel-major."""
        if self.int8:
            return self._int8(x).transpose(1, 2).contiguous()
        w = _cast(self.weight, x)
        return torch.baddbmm(_cast(self.bias, x)[None, :, None],
                             w.expand(x.shape[0], -1, -1), x.transpose(1, 2))

    def from_t(self, x: torch.Tensor) -> torch.Tensor:
        """(N, in, L) channel-major → (N, L, out)."""
        if self.int8:
            return self._int8(x.transpose(1, 2))
        w = _cast(self.weight, x)
        return torch.baddbmm(_cast(self.bias, x), x.transpose(1, 2),
                             w.t().expand(x.shape[0], -1, -1))


class Pointwise(nn.Module):
    """A 1x1 ``nn.Conv`` (``kernel`` (1, 1, in, out) ↔ ``weight``
    (out, in, 1, 1)) applied over the last axis of an NHWC tensor."""

    def __init__(self, cin: int, cout: int, bias: bool = True):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, 1, 1))
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = _cast(self.weight, x)
        return F.linear(x, w.view(w.shape[0], w.shape[1]),
                        _cast(self.bias, x))


class LayerNorm(nn.Module):
    """``nn.LayerNorm(dtype=float32)``: statistics and affine in f32 from
    f32 parameters, eps 1e-6, then cast to the input's dtype."""

    def __init__(self, c: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), (x.shape[-1],), self.scale.float(),
                            self.bias.float(), LN_EPS).to(x.dtype)


class OverlapPatchEmbed(nn.Module):
    """Strided-conv patch embedding (k7s4 for stage 0, k3s2 after) and its
    LayerNorm: NHWC → NHWC at 1/stride."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int,
                 pad: str = "same"):
        super().__init__()
        self.Conv_0 = Conv(cin, cout, kernel, stride, pad=pad)
        self.LayerNorm_0 = LayerNorm(cout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm_0(self.Conv_0(x))


class EfficientAttention(nn.Module):
    """Self-attention with spatial reduction of K/V (SegFormer's SRA).
    With ``rows`` (a shard of a frame's rows) the queries stay the
    shard's and the reduced K/V tokens are gathered from every shard, in
    row order."""

    rows = None

    def __init__(self, dim: int, num_heads: int, sr_ratio: int = 1,
                 quant: bool = False):
        super().__init__()
        self.dim, self.num_heads, self.sr_ratio = dim, num_heads, sr_ratio
        self.q = Dense(dim, dim, quant)
        self.k = Dense(dim, dim, quant)
        self.v = Dense(dim, dim, quant)
        if sr_ratio > 1:
            self.sr = Conv(dim, dim, sr_ratio, sr_ratio)
            self.sr_norm = LayerNorm(dim)
        self.proj = Dense(dim, dim, quant)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                xla_attention: bool = False) -> torch.Tensor:
        """(N, L, C) tokens of an (h, w) map → (N, L, C)."""
        n, l, c = x.shape
        h, w = hw
        heads, d = self.num_heads, self.dim // self.num_heads
        # q first, as the Flax module computes it (and creates its weights:
        # the frozen-graph converter pours in that order)
        q = (self.q(x).view(n, 1, l, d) if heads == 1
             else self.q.forward_t(x).view(n, heads, d, l))
        kv_in = x
        if self.sr_ratio > 1:
            kv_in = self.sr(x.reshape(n, h, w, c)).reshape(n, -1, c)
            kv_in = self.sr_norm(kv_in)
        if self.rows is not None:
            kv_in = self.rows.gather(kv_in, 1)
        lkv = kv_in.shape[1]
        if heads == 1:
            attend = attention_reference if xla_attention else flash_attention
            out = attend(q, self.k(kv_in).view(n, 1, lkv, d),
                         self.v(kv_in).view(n, 1, lkv, d))
            return self.proj(out.view(n, l, c))
        attend = attention_reference_t if xla_attention else flash_attention_t
        out = attend(q, self.k.forward_t(kv_in).view(n, heads, d, lkv),
                     self.v.forward_t(kv_in).view(n, heads, d, lkv))
        return self.proj.from_t(out.view(n, c, l))


class MixFFN(nn.Module):
    """SegFormer's FFN with a 3x3 depthwise conv instead of a positional
    encoding; ``exact_gelu`` picks the erf GELU over the tanh form."""

    def __init__(self, dim: int, expansion: int = 4,
                 exact_gelu: bool = False, quant: bool = False):
        super().__init__()
        hidden = dim * expansion
        self.exact_gelu = exact_gelu
        self.fc1 = Dense(dim, hidden, quant)
        self.dwconv = Conv(hidden, hidden, 3, groups=hidden)
        self.fc2 = Dense(hidden, dim, quant)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
        n, l, _ = x.shape
        y = self.fc1(x)
        y = self.dwconv(y.view(n, hw[0], hw[1], -1)).reshape(n, l, -1)
        y = F.gelu(y, approximate="none" if self.exact_gelu else "tanh")
        return self.fc2(y)


class Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, sr_ratio: int,
                 exact_gelu: bool = False, quant: bool = False):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn = EfficientAttention(dim, num_heads, sr_ratio, quant)
        self.norm2 = LayerNorm(dim)
        self.ffn = MixFFN(dim, exact_gelu=exact_gelu, quant=quant)

    def forward(self, x: torch.Tensor, hw: Tuple[int, int],
                xla_attention: bool = False) -> torch.Tensor:
        x = x + self.attn(self.norm1(x), hw, xla_attention)
        return x + self.ffn(self.norm2(x), hw)


class SegFormer(nn.Module):
    """MiT hierarchical transformer + all-MLP decode head.

    Defaults are B0; :meth:`preset` builds B0-B3 from
    :data:`SEGFORMER_PRESETS`.  Input (N, H, W, 3) NHWC with H, W divisible
    by 32, computed in :attr:`dtype`; output float32 logits (N, H, W,
    classes), or (N, H/4, W/4, classes) with ``head_upsample="quarter"``.

    ``torch_compat``: centred (k // 2) patch-embed padding and the erf GELU
    of the official implementation, instead of SAME and tanh.
    ``xla_attention`` (an attribute, read at each forward): attention
    through the plain version instead of the kernel — the yardstick.
    ``quant`` (``_int8``): the W8A8 Dense products; ``quant`` or
    ``head_cascade`` (``_hc``): the folded head (module docstring).

    Train mode (``train()``) routes as the Flax module does: attention
    through the plain version (the CUDA kernels have no backward), the
    textbook head at full resolution (no folded head, no quarter head),
    ``fuse_bn`` from batch statistics (momentum 0.9);
    :attr:`compute_dtype` computes in that dtype from f32 weights.
    ``rows``: a shard of a frame's rows (``parallel/spatial.py``), for
    the head's resizes.
    """

    compute_dtype: Optional[torch.dtype] = None
    rows = None

    def __init__(self, num_classes: int = 15,
                 widths: Sequence[int] = (32, 64, 160, 256),
                 depths: Sequence[int] = (2, 2, 2, 2),
                 num_heads: Sequence[int] = (1, 2, 5, 8),
                 sr_ratios: Sequence[int] = (8, 4, 2, 1),
                 decoder_dim: int = 256,
                 head_upsample: str = "full",
                 torch_compat: bool = False,
                 xla_attention: bool = False,
                 quant: bool = False,
                 head_cascade: bool = False):
        super().__init__()
        if head_upsample not in ("full", "quarter"):
            raise ValueError(f"head_upsample must be 'full' or 'quarter', "
                             f"got {head_upsample!r}")
        self.num_classes = num_classes
        self.depths = tuple(depths)
        self.head_upsample = head_upsample
        self.xla_attention = xla_attention
        self.quant, self.head_cascade = quant, head_cascade
        self.decoder_dim = decoder_dim
        # the JAX engine's transposed head, which folds fuse into linear_c
        self.folded_head = quant or head_cascade
        self._folded = None
        pad = "torch" if torch_compat else "same"
        cin = 3
        for s, c in enumerate(widths):
            k, stride = (7, 4) if s == 0 else (3, 2)
            setattr(self, f"embed{s}",
                    OverlapPatchEmbed(cin, c, k, stride, pad=pad))
            for b in range(depths[s]):
                setattr(self, f"stage{s}_block{b}",
                        Block(c, num_heads[s], sr_ratios[s],
                              exact_gelu=torch_compat, quant=quant))
            setattr(self, f"norm{s}", LayerNorm(c))
            setattr(self, f"linear_c{s}", Dense(c, decoder_dim))
            cin = c
        self.fuse = Pointwise(4 * decoder_dim, decoder_dim, bias=False)
        self.fuse_bn = BatchNorm(decoder_dim, BN_EPS, momentum=0.9)
        self.classifier = Pointwise(decoder_dim, num_classes)
        self.eval()     # serving routes unless train() is asked for

    @classmethod
    def preset(cls, size: str, **overrides) -> "SegFormer":
        """A B0/B1/B2/B3 variant by name."""
        kw = dict(SEGFORMER_PRESETS[size.lower()])
        kw.update(overrides)
        return cls(**kw)

    @property
    def dtype(self) -> torch.dtype:
        if self.compute_dtype is not None:
            return self.compute_dtype
        return self.embed0.Conv_0.weight.dtype

    def to_compute_dtype(self, dtype: torch.dtype) -> "SegFormer":
        """Cast the Dense and conv weights to ``dtype`` once (Flax casts
        them at every use); LayerNorm and BatchNorm stay f32, as Flax
        computes them.  The int8 Denses and, with the folded head,
        ``linear_c*`` and ``fuse`` stay f32: their int8 or folded weights
        are made from the f32 values, as the JAX program makes them."""
        keep = {id(m) for m in self.modules()
                if isinstance(m, Dense) and m.int8}
        if self.folded_head:
            keep |= {id(self.fuse)} | {id(getattr(self, f"linear_c{s}"))
                                      for s in range(4)}
        for mod in self.modules():
            if isinstance(mod, (Dense, Conv, Pointwise)) and \
                    id(mod) not in keep:
                mod.to(dtype)
        return self

    def clear(self) -> None:
        """Forget the int8 and folded weights made from the parameters."""
        self._folded = None
        for m in self.modules():
            if isinstance(m, Dense):
                m.clear()

    def load_state_dict(self, state_dict, strict: bool = True):
        out = super().load_state_dict(state_dict, strict)
        self.clear()
        return out

    def _apply(self, fn, *args, **kwargs):
        self.clear()
        return super()._apply(fn, *args, **kwargs)

    # -- the forward, in the pieces a profile times --------------------------

    def embed(self, s: int, x: torch.Tensor
              ) -> Tuple[torch.Tensor, Tuple[int, int]]:
        """Stage ``s``'s patch embedding: NHWC → ((N, h*w, C) tokens,
        (h, w))."""
        y = getattr(self, f"embed{s}")(x)
        n, h, w, c = y.shape
        return y.reshape(n, h * w, c), (h, w)

    def blocks(self, s: int, x: torch.Tensor, hw: Tuple[int, int]
               ) -> torch.Tensor:
        """Stage ``s``'s transformer blocks and norm: tokens → NHWC."""
        for b in range(self.depths[s]):
            x = getattr(self, f"stage{s}_block{b}")(
                x, hw, self.xla_attention or self.training)
        x = getattr(self, f"norm{s}")(x)
        return x.reshape(x.shape[0], hw[0], hw[1], x.shape[2])

    def head(self, feats: List[torch.Tensor], out_hw: Tuple[int, int]
             ) -> torch.Tensor:
        """All-MLP head: project every stage to the decoder width, upsample
        to 1/4, concat (stage 3 first), fuse, BatchNorm, ReLU, classify;
        the f32 logits upsampled to ``out_hw`` unless the head is
        "quarter".  With :attr:`folded_head`, :meth:`head_folded`."""
        if self.folded_head and not self.training:
            return self.head_folded(feats, out_hw)
        target = tuple(feats[0].shape[1:3])
        proj = []
        for s, f in enumerate(feats):
            p = getattr(self, f"linear_c{s}")(f)
            if tuple(p.shape[1:3]) != target:
                p = upsample_bilinear(p, target, axes=(1, 2),
                                      rows=self.rows)
            proj.append(p)
        return self._classify(self.fuse(torch.cat(proj[::-1], dim=-1)),
                              out_hw)

    def _classify(self, y: torch.Tensor, out_hw: Tuple[int, int]
                  ) -> torch.Tensor:
        y = torch.relu(self.fuse_bn(y))
        y = self.classifier(y).float()
        if self.head_upsample == "quarter" and not self.training:
            return y
        return upsample_bilinear(y, out_hw, axes=(1, 2), rows=self.rows)

    def folded(self, dtype: torch.dtype) -> List[Dense]:
        """Stage s's ``linear_c`` with its slice of the bias-free fuse
        composed in, in f32: kernel ``W_s @ fold_s``, bias ``b_s @
        fold_s``, ``fold_s`` rows (3-s)*dd:(4-s)*dd of the fuse kernel
        (in, out); an int8 Dense where C_s and dd clear the gate under
        ``quant``, else cast to ``dtype``.  Made at the first call."""
        if self._folded is None:
            dd = self.decoder_dim
            fuse = self.fuse.weight.float()[:, :, 0, 0].t()   # (4dd, dd)
            parts = []
            with torch.no_grad():
                for s in range(4):
                    lin = getattr(self, f"linear_c{s}")
                    fold = fuse[(3 - s) * dd:(4 - s) * dd]
                    d = Dense(lin.weight.shape[1], dd, self.quant).to(
                        fuse.device)
                    d.weight.copy_((lin.weight.float().t() @ fold).t())
                    d.bias.copy_(lin.bias.float() @ fold)
                    parts.append(d if d.int8 else d.to(dtype))
            self._folded = parts
        return self._folded

    def head_folded(self, feats: List[torch.Tensor],
                    out_hw: Tuple[int, int]) -> torch.Tensor:
        """The JAX engine's transposed head in NHWC: the folded products
        at each stage's resolution, summed at 1/4 resolution -- every
        part upsampled there and added in stage order, or with
        ``head_cascade`` from stage 3 up, ``acc = p_s + up(acc)`` -- in
        the compute dtype; then BatchNorm, ReLU and the classifier."""
        parts = [d(f) for d, f in zip(self.folded(feats[0].dtype), feats)]
        if self.head_cascade:
            y = parts[3]
            for p in parts[2::-1]:
                y = p + upsample_bilinear(y, tuple(p.shape[1:3]),
                                          axes=(1, 2), rows=self.rows)
        else:
            target = tuple(parts[0].shape[1:3])
            y = parts[0]
            for p in parts[1:]:
                y = y + upsample_bilinear(p, target, axes=(1, 2),
                                          rows=self.rows)
        return self._classify(y, out_hw)

    def check_input(self, x: torch.Tensor) -> None:
        if x.dim() != 4 or x.shape[1] % 32 or x.shape[2] % 32:
            raise ValueError(
                f"SegFormer needs NHWC input with H, W divisible by 32 "
                f"(4 stages of patch merging); got {tuple(x.shape)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self.check_input(x)
        out_hw = (x.shape[1], x.shape[2])
        x = x.to(self.dtype)
        feats = []
        for s in range(4):
            t, hw = self.embed(s, x)
            x = self.blocks(s, t, hw)
            feats.append(x)
        return self.head(feats, out_hw)


__all__ = ["SegFormer", "SEGFORMER_PRESETS", "EfficientAttention", "MixFFN",
           "OverlapPatchEmbed", "Block", "Dense", "Conv", "Pointwise",
           "LayerNorm", "BatchNorm"]
