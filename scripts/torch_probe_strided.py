#!/usr/bin/env python3
"""The Mosaic lowering probes of ``scripts/probe_mosaic.py``, on the GPU.

    python3 scripts/torch_probe_strided.py                # on the card
    python3 scripts/torch_probe_strided.py --device cpu   # plain versions

Runs each probe of the JAX script on the same input — ``(R, W, C) =
(16, 64, 128)`` float32 from ``numpy.random.default_rng(0).normal``, and
its bfloat16 copy — through the port's kernels (``ops/cuda/probes.py``,
source ``csrc/strided_probes.cu``):

  Q1   row-strided slice           x[0::2]                  strided_gather
  Q1b  sublane-strided slice       x[:, 0::2]               strided_gather
  Q2   sublane-splitting reshape   x.reshape(R, W/2, 2, C)[:, :, 0]
  Q3   row-splitting reshape       x.reshape(R/2, 2, W, C)[:, 0]
  Q5, Q5b, Q5c, Q5d  the same in bfloat16, and both-strided x[0::2, 0::2]
  Q4   shifted halo scratch        pad(x)[0:R, 0:W] + pad(x)[2:, 2:]  halo_add

and prints each probe's name with ``OK`` or ``WRONG RESULT``: a probe is
OK when the kernel's output equals, bit for bit, both its plain PyTorch
version and the torch expression that the JAX script's reference spells
out.  The exit code is 0 only when every probe is OK; a launch error
raises (unlike the JAX script, which probes a compiler and catches).
``--device cpu`` runs the plain versions (the kernels run only on the card).
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import Callable, List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

from bugcar_image_segmentation_tpu_torch.ops.cuda import probes  # noqa: E402

R, W, C = 16, 64, 128

# (name, kernel call, the reference expression, the dtype)
Probe = Tuple[str, Callable[[torch.Tensor], torch.Tensor],
              Callable[[torch.Tensor], torch.Tensor],
              Callable[[torch.Tensor], torch.Tensor], torch.dtype]


def _gather(sr: int, sw: int):
    return (lambda x: probes.strided_gather(x, sr, sw),
            lambda x: probes.strided_gather_reference(x, sr, sw))


def _halo_want(x: torch.Tensor) -> torch.Tensor:
    xp = F.pad(x, (0, 0, 1, 1, 1, 1))
    return xp[0:R, 0:W] + xp[2:R + 2, 2:W + 2]


PROBES: List[Probe] = [
    ("Q1 row(3rd-minor)-strided slice", *_gather(2, 1),
     lambda x: x[0:R:2], torch.float32),
    ("Q1b sublane-strided slice", *_gather(1, 2),
     lambda x: x[:, 0:W:2], torch.float32),
    ("Q2 sublane-splitting reshape", *_gather(1, 2),
     lambda x: x.reshape(R, W // 2, 2, C)[:, :, 0, :], torch.float32),
    ("Q3 row-splitting reshape", *_gather(2, 1),
     lambda x: x.reshape(R // 2, 2, W, C)[:, 0], torch.float32),
    ("Q5 bf16 row-strided", *_gather(2, 1),
     lambda x: x[0:R:2], torch.bfloat16),
    ("Q5b bf16 sublane-strided", *_gather(1, 2),
     lambda x: x[:, 0:W:2], torch.bfloat16),
    ("Q5c bf16 both-strided", *_gather(2, 2),
     lambda x: x[0:R:2, 0:W:2], torch.bfloat16),
    ("Q5d bf16 sublane reshape-split", *_gather(1, 2),
     lambda x: x.reshape(R, W // 2, 2, C)[:, :, 0, :], torch.bfloat16),
    ("Q4 shifted halo scratch", probes.halo_add, probes.halo_add_reference,
     _halo_want, torch.float32),
]


def probe_input(device) -> torch.Tensor:
    """The JAX script's input: (R, W, C) float32 normals from seed 0."""
    x = np.random.default_rng(0).normal(size=(R, W, C)).astype(np.float32)
    return torch.as_tensor(x, device=device)


def run_probes(device) -> List[Tuple[str, bool]]:
    """Every probe once through its kernel (on ``device``): (name, OK)."""
    x32 = probe_input(device)
    inputs = {torch.float32: x32, torch.bfloat16: x32.to(torch.bfloat16)}
    results = []
    for name, kernel, plain, want, dtype in PROBES:
        x = inputs[dtype]
        got = kernel(x)
        ok = (torch.equal(got, plain(x))
              and torch.equal(got, want(x).contiguous()))
        results.append((name, bool(ok)))
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels; default) or cpu (the plain "
                         "versions)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_probe_strided: no CUDA device (use --device cpu for "
              "the plain versions)", file=sys.stderr)
        return 2
    results = run_probes(device)
    for name, ok in results:
        print(f"{name}: {'OK' if ok else 'WRONG RESULT'}")
    return 0 if all(ok for _, ok in results) else 1


if __name__ == "__main__":
    sys.exit(main())
