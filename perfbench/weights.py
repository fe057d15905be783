"""Seeded weights, made on the device in a few large calls.

The layout (key, shape) of each configuration comes from its plain
reference (``reference/<model>.layout``), which holds the served
program's state-dict keys.  One normal draw fills every kernel
(LeCun-normal: N(0, 1) / sqrt(fan-in)), one uniform draw every other
leaf: norm scales in [0.7, 1.3], biases in [-0.1, 0.1], running means in
[-0.2, 0.2], running variances in [0.5, 1.5].
Both sides are handed the same dict; the program derives from it what it
serves (casts, folds, packed kernels) and the reference works that out
again.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

# leaf → (low, high) of its uniform draw
UNIFORM = {"scale": (0.7, 1.3), "bias": (-0.1, 0.1), "mean": (-0.2, 0.2),
           "var": (0.5, 1.5)}


def sub_seed(seed: int, stream: int) -> int:
    """A 63-bit seed for one of the run's random streams."""
    return int(np.random.default_rng([seed, stream]).integers(2 ** 63))


def _fan_in(key: str, shape: Tuple[int, ...]) -> int:
    if len(shape) == 2:                       # Dense (out, in)
        return shape[1]
    return shape[1] * shape[2] * shape[3]     # OIHW


def make(layout: List[Tuple[str, Tuple[int, ...]]], seed: int,
         device) -> Dict[str, torch.Tensor]:
    """float32 leaves of ``layout`` on ``device`` from ``seed``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 1))
    kernels = [(k, s) for k, s in layout if k.endswith("weight")]
    others = [(k, s) for k, s in layout if not k.endswith("weight")]
    normal = torch.randn(sum(int(np.prod(s)) for _, s in kernels),
                         generator=gen, device=device)
    uniform = torch.rand(sum(int(np.prod(s)) for _, s in others),
                         generator=gen, device=device)
    out: Dict[str, torch.Tensor] = {}
    at = 0
    for key, shape in kernels:
        n = int(np.prod(shape))
        out[key] = normal[at:at + n].view(shape) / float(
            np.sqrt(_fan_in(key, shape)))
        at += n
    at = 0
    for key, shape in others:
        n = int(np.prod(shape))
        lo, hi = UNIFORM[key.rsplit(".", 1)[1]]
        out[key] = uniform[at:at + n].view(shape) * (hi - lo) + lo
        at += n
    return {k: out[k] for k, _ in layout}
