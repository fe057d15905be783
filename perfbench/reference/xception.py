"""Plain DeepLabV3+ over Modified Aligned Xception-65 (Chen et al.,
arXiv:1802.02611) in float32 over a dict of weights in the served
program's state-dict layout.

Entry flow: a 3x3/2 conv of 32 and a 3x3 conv of 64 (each BatchNorm,
ReLU), then three blocks of three separable convs (128, 256, 728), the
last of each block at stride 2, with a 1x1/2 conv + BatchNorm shortcut.
Middle flow: 16 blocks of three separable convs of 728 with an identity
shortcut, at output stride 16.  Exit flow at dilation 2: a block of 728,
1024, 1024 with a 1x1 conv shortcut, then separable convs of 1536, 1536
and 2048.  A separable conv is a 3x3 depthwise conv, BatchNorm, ReLU, a
1x1 pointwise conv, BatchNorm and ReLU, but for a block's last, whose
output is summed with the shortcut and not activated.  ASPP of 256: a
1x1 conv, 3x3 convs at rates 6, 12 and 18, and the image-pool branch (the
mean over the map, a 1x1 conv, broadcast back), each with BatchNorm and
ReLU, concatenated and merged by a 1x1 conv.  Decoder: the ASPP output
upsampled to block 2's 1/4-resolution tap (the output of its second
separable conv), concatenated after that tap's 1x1 projection to 48, two
3x3 convs of 256, a 1x1 classifier, and the logits upsampled x4.

Departures from the paper, as the served program computes:

- ASPP and the decoder take regular 3x3 convs, where the paper's best
  model makes them separable;
- the exit flow runs dilated at output stride 16 as the paper does, but
  its separable convs never take the fused kernel in the program;
- padding is XLA's SAME rule, which pads a stride-2 3x3 conv on an even
  side by (0, 1) where TensorFlow's DeepLab pads (1, 1);
- every resize is half-pixel-centre bilinear with the edges replicated,
  where TensorFlow's DeepLab resizes with aligned corners;
- 15 classes, not Cityscapes' 19.

BatchNorm takes its running statistics (eps 1e-3).  With ``calibrate``
a forward sets every BatchNorm's running statistics in ``weights``, in
forward order, from the batch it sees: the variance is the batch's, and
the mean lies :data:`SHIFT` standard deviations below the batch's, but
for the head's last BatchNorm (``dec1``), which takes the batch's mean.
With the batch's means, a seeded 65-layer BatchNorm + ReLU network is
chaotic: a centred ReLU passes half its inputs, and each layer magnifies
a perturbation's variance about 1.47 times (0.5 / 0.34, the mean-field
gain), so bfloat16 and float8 products leave logits alike uncorrelated
with float32, where a trained network's bfloat16 logits stay close.  Two
standard deviations leave 98 % of each ReLU's inputs on the linear side
(a gain of about 1.02 a layer); the centred last one keeps the logits'
class means from swamping their spatial variation, so a frame holds more
than one class.  The image-pool branch sees one value a channel a frame;
its statistics are those of its 1x1 conv over every pixel of the map it
pools (their mean is that of the pooled value).  Every product goes
through ``common.conv2d``, so a :class:`~.common.Precision` rounds its
operands.  It imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from .common import Precision, conv2d, resize_bilinear

BN_EPS = 1e-3
SHIFT = 2.0         # calibrated means, in sd below the batch's
CENTRED = "dec1.BatchNorm_0"


def _conv(key: str, cin: int, cout: int, k: int, groups: int = 1):
    return [(f"{key}.weight", (cout, cin // groups, k, k))]


def _norm(key: str, c: int):
    return [(f"{key}.{leaf}", (c,)) for leaf in ("scale", "bias", "mean",
                                                  "var")]


def _conv_bn(key: str, cin: int, cout: int, k: int):
    return _conv(f"{key}.Conv_0", cin, cout, k) + _norm(f"{key}.BatchNorm_0",
                                                        cout)


def _sep(key: str, cin: int, cout: int):
    return (_conv(f"{key}.depthwise", cin, cin, 3, groups=cin)
            + _norm(f"{key}.depthwise_bn", cin)
            + _conv(f"{key}.pointwise", cin, cout, 1)
            + _norm(f"{key}.pointwise_bn", cout))


def _block(key: str, cin: int, widths, shortcut: bool):
    out, c = [], cin
    for i, f in enumerate(widths):
        out += _sep(f"{key}.sep{i}", c, f)
        c = f
    if shortcut:
        out += _conv(f"{key}.shortcut", cin, widths[-1], 1)
        out += _norm(f"{key}.shortcut_bn", widths[-1])
    return out


def blocks(cfg: dict) -> List[Tuple[str, int, Tuple[int, ...], int, int,
                                    bool]]:
    """(key, cin, widths, stride, dilation, conv shortcut) of every
    Xception block, in forward order."""
    m = cfg["model"]
    out, cin = [], m["stem"][-1]
    for i, f in enumerate(m["entry_widths"]):
        out.append((f"block{i + 1}", cin, (f, f, f), 2, 1, True))
        cin = f
    for i in range(m["middle_blocks"]):
        out.append((f"middle{i}", cin, (cin,) * 3, 1, 1, False))
    out.append(("exit1", cin, tuple(m["exit_widths"]), 1,
                m["exit_dilation"], True))
    return out


def layout(cfg: dict) -> List[Tuple[str, Tuple[int, ...]]]:
    """(key, shape) of every weight, in the served state-dict layout."""
    m = cfg["model"]
    s0, s1 = m["stem"]
    out = _conv_bn("conv1_1", 3, s0, 3) + _conv_bn("conv1_2", s0, s1, 3)
    for key, cin, widths, _, _, shortcut in blocks(cfg):
        out += _block(key, cin, widths, shortcut)
    cin = m["exit_widths"][-1]
    for i, f in enumerate(m["exit_sep_widths"]):
        out += _sep(f"exit_sep{i}", cin, f)
        cin = f
    a = m["aspp_dim"]
    out += _conv_bn("aspp.b0", cin, a, 1)
    for i in range(len(m["aspp_rates"])):
        out += _conv_bn(f"aspp.b{i + 1}", cin, a, 3)
    out += _conv_bn("aspp.image_pool", cin, a, 1)
    out += _conv_bn("aspp.merge", (len(m["aspp_rates"]) + 2) * a, a, 1)
    low = m["entry_widths"][1]
    out += _conv_bn("low_proj", low, m["low_level"], 1)
    d = m["decoder_dim"]
    out += _conv_bn("dec0", a + m["low_level"], d, 3)
    out += _conv_bn("dec1", d, d, 3)
    out += [("classifier.weight", (cfg["num_classes"], d, 1, 1)),
            ("classifier.bias", (cfg["num_classes"],))]
    return out


class Model:
    """``Model(weights, cfg, precision)(x)``: (N, H, W, 3) float32 NHWC, H
    and W divisible by the output stride → (N, H, W, classes) float32
    logits.  With ``calibrate`` a forward sets every BatchNorm's running
    statistics in ``weights`` from the batch it sees (module docstring)."""

    def __init__(self, weights: Dict[str, torch.Tensor], cfg: dict,
                 precision: Precision, calibrate: bool = False):
        self.w, self.cfg, self.m, self.p = (weights, cfg, cfg["model"],
                                            precision)
        self.calibrate = calibrate

    def _bn(self, key: str, y: torch.Tensor, stats=None) -> torch.Tensor:
        """BatchNorm of NCHW ``y`` from ``key``'s running statistics;
        with ``calibrate``, first set them from ``stats`` (``y``)."""
        if self.calibrate:
            s = y if stats is None else stats
            var = s.var((0, 2, 3), unbiased=False)
            shift = 0.0 if key == CENTRED else SHIFT
            self.w[f"{key}.mean"] = s.mean((0, 2, 3)) - shift * var.sqrt()
            self.w[f"{key}.var"] = var

        def col(leaf):
            return self.w[f"{key}.{leaf}"].view(1, -1, 1, 1)

        return ((y - col("mean")) * torch.rsqrt(col("var") + BN_EPS)
                * col("scale") + col("bias"))

    def _conv(self, key: str, x: torch.Tensor, stride: int = 1,
              dilation: int = 1, groups: int = 1) -> torch.Tensor:
        return conv2d(self.p, x, self.w[f"{key}.weight"], None, stride,
                      dilation, groups)

    def _conv_bn(self, key: str, x: torch.Tensor, stride: int = 1,
                 dilation: int = 1) -> torch.Tensor:
        y = self._conv(f"{key}.Conv_0", x, stride, dilation)
        return torch.relu(self._bn(f"{key}.BatchNorm_0", y))

    def _sep(self, key: str, x: torch.Tensor, stride: int, dilation: int,
             act_out: bool) -> torch.Tensor:
        y = self._conv(f"{key}.depthwise", x, stride, dilation,
                       groups=x.shape[1])
        y = torch.relu(self._bn(f"{key}.depthwise_bn", y))
        y = self._bn(f"{key}.pointwise_bn", self._conv(f"{key}.pointwise", y))
        return torch.relu(y) if act_out else y

    def _block(self, key: str, x: torch.Tensor, n_sep: int, stride: int,
               dilation: int, shortcut: bool
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """(the block's output, its second separable conv's output)."""
        y = x
        for i in range(n_sep):
            last = i == n_sep - 1
            y = self._sep(f"{key}.sep{i}", y, stride if last else 1,
                          dilation, act_out=not last)
            if i == 1:
                mid = y
        if shortcut:
            return y + self._bn(f"{key}.shortcut_bn",
                                self._conv(f"{key}.shortcut", x, stride)), mid
        return y + x, mid

    def _aspp(self, x: torch.Tensor) -> torch.Tensor:
        rates = self.m["aspp_rates"]
        branches = [self._conv_bn("aspp.b0", x)]
        branches += [self._conv_bn(f"aspp.b{i + 1}", x, dilation=r)
                     for i, r in enumerate(rates)]
        key = "aspp.image_pool"
        pooled = self._conv(f"{key}.Conv_0", x.mean((2, 3), keepdim=True))
        pixels = (self._conv(f"{key}.Conv_0", x) if self.calibrate
                  else None)
        pooled = torch.relu(self._bn(f"{key}.BatchNorm_0", pooled, pixels))
        branches.append(pooled.expand(-1, -1, x.shape[2], x.shape[3]))
        return self._conv_bn("aspp.merge", torch.cat(branches, 1))

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        n, h, w, _ = x.shape
        y = self._conv_bn("conv1_2", self._conv_bn("conv1_1",
                                                   x.permute(0, 3, 1, 2), 2))
        for key, _, widths, stride, dilation, shortcut in blocks(self.cfg):
            y, mid = self._block(key, y, len(widths), stride, dilation,
                                 shortcut)
            if key == "block2":
                low = mid
        for i in range(len(self.m["exit_sep_widths"])):
            y = self._sep(f"exit_sep{i}", y, 1, self.m["exit_dilation"],
                          act_out=True)
        y = resize_bilinear(self._aspp(y), (low.shape[2], low.shape[3]))
        y = torch.cat([y, self._conv_bn("low_proj", low)], 1)
        y = self._conv_bn("dec1", self._conv_bn("dec0", y))
        y = conv2d(self.p, y, self.w["classifier.weight"],
                   self.w["classifier.bias"])
        return resize_bilinear(y, (h, w)).permute(0, 2, 3, 1)
