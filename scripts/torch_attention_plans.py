#!/usr/bin/env python3
"""How the bf16 flash attention's CTA widths compare on one NVIDIA GPU.

    python3 scripts/torch_attention_plans.py

from the root of a checkout, on the GPU host.  The bf16 kernel of
``csrc/flash_attention.cu`` takes 32, 64 or (at d = 32) 128 queries a CTA,
chosen from (Nq, d, layout) alone (``bugcar_flash_attention_rows``).  This
script times every width at SegFormer-B0's four stage shapes at
1024x1024 (d 32, 1024 keys after the spatial reduction), in both layouts:
one JSON line per (shape, layout) with the microseconds of each width
(bare launches through the C launcher, seeded normal bf16 operands, CUDA
events), the plan's own width, its CTAs and the fastest width; then the
nvidia-smi name/power-limit line.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import math
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

# (B, H, Nq, Nkv, d): SegFormer-B0's attention at 1024x1024, stages 0-3
STAGES = [(1, 1, 65536, 1024, 32), (1, 2, 16384, 1024, 32),
          (1, 5, 4096, 1024, 32), (1, 8, 1024, 1024, 32)]
ITERS = 200


def cuda_us(fn, iters: int) -> float:
    import torch
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


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_plans: no CUDA device", file=sys.stderr)
        return 2
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    lib = kbuild.library()
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, nq, nkv, d in STAGES:
        rng = np.random.default_rng(0)
        base = [torch.as_tensor(rng.standard_normal((b, h, n, d)).astype(
            np.float32), device="cuda").bfloat16() for n in (nq, nkv, nkv)]
        for cm in (False, True):
            q, k, v = ((x.transpose(-1, -2).contiguous() for x in base)
                       if cm else base)
            out = torch.empty_like(q)
            us = {}
            for rows in (32, 64, 128):
                raw = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b * h, nq, nkv, d,
                       ctypes.c_float(1.0 / math.sqrt(d)), int(cm), rows,
                       stream)
                kbuild.check(lib.bugcar_flash_attention_bf16_rows(*raw),
                             f"rows {rows}")
                us[rows] = cuda_us(
                    lambda: lib.bugcar_flash_attention_bf16_rows(*raw), ITERS)
            plan = lib.bugcar_flash_attention_rows(nq, d, 1, int(cm))
            print(json.dumps({
                "shape": [b, h, nq, nkv, d],
                "layout": "channel-major" if cm else "token-major",
                "us_by_queries_per_cta": us, "plan": plan,
                "plan_ctas": -(-nq // plan) * b * h,
                "fastest": min(us, key=us.get)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
