"""Plain SegFormer (Xie et al., arXiv:2105.15203) in float32 over a dict
of weights in the served program's state-dict layout.

Mix Transformer encoder: per stage an overlapped patch embedding (7x7/4,
then 3x3/2, SAME padding) and LayerNorm, blocks of efficient
self-attention (K and V from the tokens reduced by an sr x sr / sr conv
and a LayerNorm; heads split channel-major, c = head * d + j) and Mix-FFN
(fc1, 3x3 depthwise conv, tanh GELU, fc2), each behind a LayerNorm
(eps 1e-6) with a residual, then the stage's LayerNorm.  All-MLP head:
each stage projected to the decoder width, bilinearly resized to 1/4
(half-pixel centres), concatenated stage 3 first, a bias-free 1x1 fuse,
BatchNorm from running statistics (eps 1e-5), ReLU, a 1x1 classifier,
and the logits resized x4.  Attention runs in blocks of queries so that
the scores fit.  It imports nothing of the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .common import (Precision, conv2d, layer_norm, linear, matmul,
                     resize_bilinear)

LN_EPS = 1e-6
BN_EPS = 1e-5
QUERY_BLOCK = 8192


def _dense(key: str, cin: int, cout: int):
    return [(f"{key}.weight", (cout, cin)), (f"{key}.bias", (cout,))]


def _norm(key: str, c: int):
    return [(f"{key}.scale", (c,)), (f"{key}.bias", (c,))]


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every weight, in the served state-dict layout."""
    m = cfg["model"]
    widths, depths, srs = m["widths"], m["depths"], m["sr_ratios"]
    dd, mlp = m["decoder_dim"], m["mlp_ratio"]
    out = []
    cin = 3
    for s, c in enumerate(widths):
        k = 7 if s == 0 else 3
        out += [(f"embed{s}.Conv_0.weight", (c, cin, k, k)),
                (f"embed{s}.Conv_0.bias", (c,))]
        out += _norm(f"embed{s}.LayerNorm_0", c)
        for b in range(depths[s]):
            p = f"stage{s}_block{b}"
            out += _norm(f"{p}.norm1", c)
            for n in ("q", "k", "v"):
                out += _dense(f"{p}.attn.{n}", c, c)
            if srs[s] > 1:
                out += [(f"{p}.attn.sr.weight", (c, c, srs[s], srs[s])),
                        (f"{p}.attn.sr.bias", (c,))]
                out += _norm(f"{p}.attn.sr_norm", c)
            out += _dense(f"{p}.attn.proj", c, c)
            out += _norm(f"{p}.norm2", c)
            out += _dense(f"{p}.ffn.fc1", c, mlp * c)
            out += [(f"{p}.ffn.dwconv.weight", (mlp * c, 1, 3, 3)),
                    (f"{p}.ffn.dwconv.bias", (mlp * c,))]
            out += _dense(f"{p}.ffn.fc2", mlp * c, c)
        out += _norm(f"norm{s}", c)
        out += _dense(f"linear_c{s}", c, dd)
        cin = c
    out.append(("fuse.weight", (dd, 4 * dd, 1, 1)))
    out += [(f"fuse_bn.{k}", (dd,)) for k in ("scale", "bias", "mean", "var")]
    out += [("classifier.weight", (cfg["num_classes"], dd, 1, 1)),
            ("classifier.bias", (cfg["num_classes"],))]
    return out


class Model:
    """``Model(weights, cfg, precision)(x)``: (N, H, W, 3) float32 NHWC, H
    and W divisible by 32 → (N, H, W, classes) float32 logits.  With
    ``calibrate`` a forward sets the head BatchNorm's running statistics
    in ``weights`` to those of the batch it sees."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: dict,
                 precision: Precision, calibrate: bool = False):
        self.w, self.m, self.p = weights, cfg["model"], precision
        self.calibrate = calibrate

    def _ln(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.w[f"{key}.scale"], self.w[f"{key}.bias"],
                          LN_EPS)

    def _dense(self, key: str, x: torch.Tensor) -> torch.Tensor:
        return linear(self.p, x, self.w[f"{key}.weight"],
                      self.w[f"{key}.bias"])

    def _conv(self, key: str, x: torch.Tensor, stride: int = 1,
              groups: int = 1) -> torch.Tensor:
        """NHWC conv with SAME padding."""
        y = conv2d(self.p, x.permute(0, 3, 1, 2), self.w[f"{key}.weight"],
                   self.w[f"{key}.bias"], stride=stride, groups=groups)
        return y.permute(0, 2, 3, 1)

    def _attention(self, q, k, v) -> torch.Tensor:
        """softmax(q kᵀ / sqrt(d)) v on (N, heads, L, d), in query
        blocks."""
        scale = 1.0 / math.sqrt(q.shape[-1])
        kt = k.transpose(-1, -2)
        out = []
        for i in range(0, q.shape[2], QUERY_BLOCK):
            s = matmul(self.p, q[:, :, i:i + QUERY_BLOCK], kt) * scale
            out.append(matmul(self.p, torch.softmax(s, -1), v))
        return torch.cat(out, 2)

    def _attn(self, key: str, s: int, x: torch.Tensor, hw) -> torch.Tensor:
        n, l, c = x.shape
        heads, sr = self.m["num_heads"][s], self.m["sr_ratios"][s]
        d = c // heads

        def split(t):
            return t.view(n, -1, heads, d).transpose(1, 2)

        q = split(self._dense(f"{key}.q", x))
        kv = x
        if sr > 1:
            kv = self._conv(f"{key}.sr", x.view(n, hw[0], hw[1], c), sr)
            kv = self._ln(f"{key}.sr_norm", kv.reshape(n, -1, c))
        o = self._attention(q, split(self._dense(f"{key}.k", kv)),
                            split(self._dense(f"{key}.v", kv)))
        return self._dense(f"{key}.proj", o.transpose(1, 2).reshape(n, l, c))

    def _ffn(self, key: str, x: torch.Tensor, hw) -> torch.Tensor:
        n, l, _ = x.shape
        y = self._dense(f"{key}.fc1", x)
        hidden = y.shape[-1]
        y = self._conv(f"{key}.dwconv", y.view(n, hw[0], hw[1], hidden),
                       groups=hidden).reshape(n, l, hidden)
        return self._dense(f"{key}.fc2", F.gelu(y, approximate="tanh"))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        feats = []
        for s in range(4):
            x = self._conv(f"embed{s}.Conv_0", x, 4 if s == 0 else 2)
            hw = (x.shape[1], x.shape[2])
            t = self._ln(f"embed{s}.LayerNorm_0", x.reshape(n, -1, x.shape[3]))
            for b in range(self.m["depths"][s]):
                key = f"stage{s}_block{b}"
                t = t + self._attn(f"{key}.attn", s,
                                   self._ln(f"{key}.norm1", t), hw)
                t = t + self._ffn(f"{key}.ffn",
                                  self._ln(f"{key}.norm2", t), hw)
            x = self._ln(f"norm{s}", t).view(n, hw[0], hw[1], -1)
            feats.append(x)
        quarter = (feats[0].shape[1], feats[0].shape[2])
        parts = [resize_bilinear(self._dense(f"linear_c{s}", f), quarter,
                                 axes=(1, 2)) for s, f in enumerate(feats)]
        y = torch.cat(parts[::-1], -1)
        fuse = self.w["fuse.weight"]
        y = linear(self.p, y, fuse.view(fuse.shape[0], -1))
        if self.calibrate:
            self.w["fuse_bn.mean"] = y.mean((0, 1, 2))
            self.w["fuse_bn.var"] = y.var((0, 1, 2), unbiased=False)
        bn = {k: self.w[f"fuse_bn.{k}"] for k in ("scale", "bias", "mean",
                                                   "var")}
        y = ((y - bn["mean"]) * (bn["scale"] * torch.rsqrt(bn["var"] + BN_EPS))
             + bn["bias"])
        cls = self.w["classifier.weight"]
        y = linear(self.p, torch.relu(y), cls.view(cls.shape[0], -1),
                   self.w["classifier.bias"])
        return resize_bilinear(y, (h, w), axes=(1, 2))
