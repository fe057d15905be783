#!/usr/bin/env python3
"""How the bf16 flash attention's launch plans compare on one NVIDIA GPU.

    python3 scripts/torch_attention_plans.py

from the root of a checkout, on the GPU host.  The bf16 kernel of
``csrc/flash_attention.cu`` (``flash_attention_wgmma``) takes 64 queries
a consumer warpgroup, one or two consumers a CTA (64 or 128 queries), and
streams K/V tiles of 128 keys through a ring of 2-4 stages; its plan is
chosen from (Nq, d) alone (``bugcar_flash_attention_plan``).
This script times every plan at SegFormer-B0's four stage shapes at
1024x1024 (d 32, 1024 keys after the spatial reduction) and B2's (d 64),
in both layouts: one JSON line per (shape, layout) with the microseconds
of each plan (bare launches through the C launcher, seeded normal bf16
operands, CUDA events), the chosen plan, its CTAs, the fastest plan and,
as a yardstick, ``torch.nn.functional.scaled_dot_product_attention`` on
token-major operands (its event-timed loop includes its dispatch on the
host); then the nvidia-smi name/power-limit line.  Every plan gives the same
bits (a card test holds it).  Exits non-zero without a CUDA device.
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

# (B, H, Nq, Nkv): SegFormer's attention at 1024x1024, stages 0-3; at d 32
# (B0) and d 64 (B2)
STAGES = [(1, 1, 65536, 1024), (1, 2, 16384, 1024), (1, 5, 4096, 1024),
          (1, 8, 1024, 1024)]
HEAD_DIMS = (32, 64)
PLANS = [(rows, stages) for rows in (64, 128) for stages in (2, 3, 4)]
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
    import torch.nn.functional as F
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
    for d in HEAD_DIMS:
        for b, h, nq, nkv in STAGES:
            rng = np.random.default_rng(0)
            base = [torch.as_tensor(rng.standard_normal((b, h, n, d)).astype(
                np.float32), device="cuda").bfloat16() for n in (nq, nkv, nkv)]
            for cm in (False, True):
                q, k, v = ((x.transpose(-1, -2).contiguous() for x in base)
                           if cm else base)
                out = torch.empty_like(q)
                us = {}
                for rows, stages in PLANS:
                    raw = (q.data_ptr(), k.data_ptr(), v.data_ptr(),
                           out.data_ptr(), b * h, nq, nkv, d,
                           ctypes.c_float(1.0 / math.sqrt(d)), int(cm), rows,
                           stages, stream)
                    kbuild.check(lib.bugcar_flash_attention_bf16_plan(*raw),
                                 f"plan {rows}/{stages}")
                    us[f"{rows}/{stages}"] = cuda_us(
                        lambda: lib.bugcar_flash_attention_bf16_plan(*raw),
                        ITERS)
                plan = (ctypes.c_int * 5)()
                lib.bugcar_flash_attention_plan(nq, d, 1, plan)
                sdpa = cuda_us(
                    lambda: F.scaled_dot_product_attention(*base), ITERS)
                print(json.dumps({
                    "shape": [b, h, nq, nkv, d],
                    "layout": "channel-major" if cm else "token-major",
                    "us_by_queries_per_cta_and_stages": us,
                    "plan": f"{plan[0]}/{plan[1]}",
                    "plan_ctas": -(-nq // plan[0]) * b * h,
                    "fastest": min(us, key=us.get),
                    "sdpa_token_major_us": sdpa}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
