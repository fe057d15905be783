#!/usr/bin/env python3
"""How the fused bottleneck's bf16 kernel and its plain version round, on
one NVIDIA GPU.

    python3 scripts/torch_bottleneck_rounding.py

from the root of a checkout, on the GPU host.  The bf16 kernel
(``csrc/fused_bottleneck.cu``, ``fused_bottleneck_mma``) rounds y1, the 5x1
result, y2 and the output as an f32 FMA chain over the input channels in
order would, where the TPU kernel rounds them.  This script holds it,
block by block along ENet's trunk, against

- the plain version (``fused_bottleneck_ref`` on the card: cuDNN's f32
  convolutions, TF32 off) under chip_smoke.py's bf16 budget, |got - ref| <=
  2^-6 + 2^-5 |ref| -- the gate the smoke applies;
- an f64 model with the same bf16 rounding points (its sums and
  epilogues exact to f32 precision), under the same budget, and the share
  of outputs whose bits differ from it; the plain version too;

on the trunk activations of a seeded ENet (``random_enet_variables(0)``,
bf16) for synthetic frames 0 (alone) and 0-3, 4-7, 8-11, 12-15 (batches of
4), each block fed the plain version's output of the block before, as
chip_smoke.py's kernels phase does (frames 0 and 0-3 are its own).  One
JSON line per (frames, block): over-budget counts and the largest
|err| / budget; then one line of totals per frame set; then the
nvidia-smi name/power-limit line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

ATOL, RTOL = 2 ** -6, 2 ** -5        # chip_smoke.py TOL["bfloat16"]
CHAINS = [(0, 1), (0, 4), (4, 4), (8, 4), (12, 4)]   # (first frame, frames)


def exact_model(x, wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao, *,
                kind, dilation):
    """The plain version in float64, bf16 at the same rounding points."""
    import torch
    import torch.nn.functional as F

    def q(t):
        return t.to(torch.bfloat16).double()

    def vec(v):
        return v.double().reshape(1, -1, 1, 1)

    def prelu(v, a):
        return torch.where(v >= 0, v, a * v)

    xf = x.double().permute(0, 3, 1, 2)
    y1 = F.conv2d(xf, q(wp).t().reshape(32, 128, 1, 1))
    y1 = q(prelu(y1 * vec(s1) + vec(b1), vec(a1)))
    if kind == "asymmetric":
        w51, w15 = wcore
        z = q(F.conv2d(y1, q(w51).permute(3, 2, 0, 1), padding=(2, 0)))
        acc = F.conv2d(z, q(w15).permute(3, 2, 0, 1), padding=(0, 2))
    else:
        acc = F.conv2d(y1, q(wcore).permute(3, 2, 0, 1), padding=dilation,
                       dilation=dilation)
    y2 = q(prelu(acc * vec(s2) + vec(b2), vec(a2)))
    y3 = F.conv2d(y2, q(we).t().reshape(128, 32, 1, 1)) * vec(s3) + vec(b3)
    return prelu(y3 + xf, vec(ao)).to(torch.bfloat16).permute(0, 2, 3, 1)


def budget(got, ref) -> list:
    """[outputs over the budget, largest |err| / budget]."""
    diff = (got.float() - ref.float()).abs()
    lim = ATOL + RTOL * ref.float().abs()
    return [int((diff > lim).sum()), float((diff / lim).max())]


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_bottleneck_rounding: no CUDA device", file=sys.stderr)
        return 2
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.ops.cuda import bottleneck as bn

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    frames = [f for f, _, _ in synthetic.video(seed=0, num_frames=16,
                                                 shape=(480, 640))]
    eng = port.build_engine("enet_fused", port.ModelConfig(name="enet_fused"),
                            variables=random_enet_variables(0), device="cuda")
    blocks = eng.forward_fn.blocks

    def args_of(blk):
        return (blk.wp, blk.s1, blk.b1, blk.a1, blk.wcore(), blk.s2, blk.b2,
                blk.a2, blk.we, blk.s3, blk.b3, blk.ao)

    with torch.no_grad():
        for f0, nf in CHAINS:
            x = pre.preprocess_for_config(torch.as_tensor(
                np.stack(frames[f0:f0 + nf])).cuda(), eng.cfg)
            x, _, _ = eng.module.encode(x)
            x = x.permute(0, 2, 3, 1).contiguous()
            total = {"kernel_vs_plain": 0, "kernel_vs_f64": 0,
                     "plain_vs_f64": 0}
            for i, blk in enumerate(blocks):
                kw = dict(kind=blk.kind, dilation=blk.dilation)
                got = blk(x)
                ref = bn.fused_bottleneck_ref(x, *args_of(blk), **kw)
                ex = exact_model(x, *args_of(blk), **kw)
                rec = {"frames": [f0, f0 + nf], "block": i, "kind": blk.kind,
                       "dilation": blk.dilation,
                       "kernel_vs_plain": budget(got, ref),
                       "kernel_vs_f64": budget(got, ex),
                       "plain_vs_f64": budget(ref, ex),
                       "share_not_f64": {
                           k: float((v != ex).float().mean())
                           for k, v in (("kernel", got), ("plain", ref))}}
                for k in total:
                    total[k] += rec[k][0]
                print(json.dumps(rec), flush=True)
                x = ref
            print(json.dumps({"frames": [f0, f0 + nf],
                              "outputs_over_budget": total}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
