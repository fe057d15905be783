#!/usr/bin/env python3
"""How the fused sepconv's launch plans compare on one NVIDIA GPU.

    python3 scripts/torch_sepconv_plans.py

from the root of a checkout, on the GPU host.  ``ops/cuda/sepconv.plan``
picks, per site shape, the pixel tile (8 or 4 rows), the thread block
cluster size G and the weight ring's stages from a cost model and a table
of the card's cluster occupancy.  This script measures what the model
stands in for:

- one JSON line ``{"max_clusters": ...}``: the clusters of G = 1..8 CTAs
  the card holds at once, with the shared memory of one and of two CTAs
  an SM (``cudaOccupancyMaxActiveClusters``; the table ``MAX_CLUSTERS``
  records it);
- one JSON line per site shape of the Xception path at 1024x512 (and the
  two stride-2 extras): the time of every plan the kernel takes (bare
  launches through the C launcher, bf16, N = 1, seeded data, CUDA
  events), keyed ``"rows/G/stages"``, the plan's own choice and the five
  fastest;

then the nvidia-smi name/power-limit line.  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (H, W, C, F, stride, act_out)
SITES = [(256, 512, 64, 128, 1, True), (256, 512, 128, 128, 1, True),
         (256, 512, 128, 128, 2, False), (128, 256, 128, 256, 1, True),
         (128, 256, 256, 256, 1, True), (64, 128, 256, 728, 1, True),
         (64, 128, 728, 728, 1, True), (32, 64, 728, 728, 1, True),
         (128, 256, 256, 256, 2, False), (64, 128, 728, 728, 2, False)]


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_sepconv_plans: no CUDA device", file=sys.stderr)
        return 2
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
    from bugcar_image_segmentation_tpu_torch.ops.cuda import sepconv as sc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    lib = kbuild.library()
    # shared memory of a CTA that leaves room for two an SM, and of one alone
    smem = {2: sc.SMEM_SM // 2 - 1024, 1: sc.SMEM_CTA}
    print(json.dumps({"max_clusters": {
        per_sm: [lib.bugcar_fused_sepconv_max_clusters(8, b, g)
                 for g in range(1, 9)] for per_sm, b in smem.items()},
        "model": {k: list(v) for k, v in sc.MAX_CLUSTERS.items()},
        "nvidia_smi": smi}), flush=True)

    def us(fn, iters=30):
        for _ in range(3):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        stop.record()
        stop.synchronize()
        return 1e3 * start.elapsed_time(stop) / iters

    gen = torch.Generator(device="cuda").manual_seed(0)
    for h, w, c, f, stride, act in SITES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        x = rnd(1, h, w, c).bfloat16()
        args = [rnd(3, 3, 1, c) * 0.3, rnd(c).abs() + 0.5, rnd(c) * 0.1,
                (rnd(c, f) / c ** 0.5).bfloat16(), rnd(f).abs() + 0.5,
                rnd(f) * 0.1]
        out = torch.empty(1, h // stride, w // stride, f, device="cuda",
                          dtype=torch.bfloat16)
        raw = list(sc.launch_args(x, out, *args, strides=stride,
                                  act_out=act))
        times = {}
        for rows in (8, 4):
            for g in range(1, 9):
                for stages in (4, 3, 2):
                    raw[16:19] = [rows, g, stages]
                    if lib.bugcar_fused_sepconv(*raw) != 0:
                        continue     # a plan the kernel refuses
                    times[f"{rows}/{g}/{stages}"] = us(
                        lambda r=tuple(raw): lib.bugcar_fused_sepconv(*r))
        pl = sc.plan(h, w, c, f, stride)
        chosen = f"{pl.tile_rows}/{pl.cluster}/{pl.stages}"
        print(json.dumps({
            "shape": [h, w, c, f], "stride": stride, "plan": chosen,
            "plan_us": times[chosen],
            "fastest": sorted(times.items(), key=lambda kv: kv[1])[:5],
            "us": times, "nvidia_smi": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
