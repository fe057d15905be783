#!/usr/bin/env python3
"""Where a bf16 flash-attention launch spends its time, part by part, on
one NVIDIA GPU.

    python3 scripts/torch_attention_split.py

from the root of a checkout, on the GPU host.  The card's profilers that
count stalls do not run there, so this script builds variants of
``csrc/flash_attention.cu`` with plain nvcc (into
``build/attention_split/``), each with one part of the bf16 kernel
(``flash_attention_wgmma``) switched off behind a condition that is false
at run time: the exps (p = s c - m on the FMA pipe instead of ex2 on the
SFU), the whole softmax step (max, exps, sums), and the P_lo.V products.
It times each with CUDA events
(bare launches of ``bugcar_flash_attention[_t]``, the default plan,
seeded normal bf16 operands) at SegFormer-B0's four stage shapes at
1024x1024 and B2's stage 0, in both layouts, and prints one JSON line per
(shape, layout): ``kernel_us`` and ``part_us``, the time each part adds
(the kernel's time less the variant's; parts overlap, so these are the
exposed shares and need not sum to the total); then the nvidia-smi
name/power-limit line.  A variant's output is wrong by design; only its
time is read.  Exits non-zero without a CUDA device.
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

SOURCE = os.path.join(REPO, "bugcar_image_segmentation_tpu_torch", "csrc",
                      "flash_attention.cu")
OUT = os.path.join(REPO, "build", "attention_split")
# variant -> [(text of the source, its replacement, occurrences), ...]; the
# part a variant switches off is the difference between the kernel and it.
VARIANTS = {
    "kernel": [],
    "exps": [("    const float p = ex2(fmaf(s[i], c, -m[(i >> 1) & 1]));",
              "    const float p = c < 0.f ? ex2(fmaf(s[i], c, -m[(i >> 1) & 1]))"
              " : fmaf(s[i], c, -m[(i >> 1) & 1]);", 1)],
    "softmax": [("    softmax_step(s, m, l, alpha, nkv, tq, scale_log2);",
                 "    if (scale_log2 < 0.f) softmax_step(s, m, l, alpha, nkv, tq,"
                 " scale_log2);", 1),
                ("      softmax_step(s, m, l, alpha, nkv - (j + 1) * kKeys, tq,"
                 " scale_log2);",
                 "      if (scale_log2 < 0.f) softmax_step(s, m, l, alpha, nkv -"
                 " (j + 1) * kKeys, tq, scale_log2);", 1)],
    "p_lo_products": [("      wgmma_rs_n32<!kCM>(o, lo[kk], db);", "", 1),
                      ("      wgmma_rs_n64<!kCM>(o, lo[kk], db);", "", 1)],
}
# (B, H, Nq, Nkv, d): SegFormer-B0's attention at 1024x1024, stages 0-3,
# and B2's stage 0
SHAPES = [(1, 1, 65536, 1024, 32), (1, 2, 16384, 1024, 32),
          (1, 5, 4096, 1024, 32), (1, 8, 1024, 1024, 32),
          (1, 1, 65536, 1024, 64)]


def build(nvcc: str, variants=VARIANTS) -> dict:
    """The variants' libraries (name -> ctypes library), compiled in
    parallel."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
    os.makedirs(OUT, exist_ok=True)
    text = open(SOURCE).read()
    procs = []
    for name, subs in variants.items():
        src = text
        for old, new, count in subs:
            if src.count(old) != count:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old!r} {count} time(s)")
            src = src.replace(old, new)
        cu, so = (os.path.join(OUT, f"{name}.cu"),
                  os.path.join(OUT, f"{name}.so"))
        with open(cu, "w") as f:
            f.write(src)
        flags = [a for a in kbuild.NVCC_FLAGS if a not in ("-Xptxas", "-v")]
        procs.append((name, so, subprocess.Popen(
            [nvcc, *flags, "-I", os.path.dirname(SOURCE), "-shared", "-o", so,
             cu],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(so)
        for fn in (lib.bugcar_flash_attention, lib.bugcar_flash_attention_t):
            fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def split(libs: dict, entry: str, raw: tuple, iters: int) -> dict:
    """``kernel_us`` and ``part_us`` of one launch (its C arguments)."""
    import torch

    def us(fn):
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

    times = {}
    for name, lib in libs.items():
        fn = getattr(lib, entry)
        err = fn(*raw)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        times[name] = us(lambda fn=fn: fn(*raw))
    return {"kernel_us": times["kernel"],
            "part_us": {k: times["kernel"] - v for k, v in times.items()
                        if k != "kernel"}}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_attention_split: no CUDA device", file=sys.stderr)
        return 2
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    libs = build(kbuild._nvcc())
    stream = torch.cuda.current_stream().cuda_stream
    for b, h, nq, nkv, d in SHAPES:
        rng = np.random.default_rng(0)
        base = [torch.as_tensor(rng.standard_normal((b, h, n, d)).astype(
            np.float32), device="cuda").bfloat16() for n in (nq, nkv, nkv)]
        for cm in (False, True):
            q, k, v = ((x.transpose(-1, -2).contiguous() for x in base)
                       if cm else base)
            out = torch.empty_like(q)
            raw = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                   b * h, nq, nkv, d, ctypes.c_float(1.0 / math.sqrt(d)), 1,
                   stream)
            entry = ("bugcar_flash_attention_t" if cm
                     else "bugcar_flash_attention")
            iters = max(20, min(200, int(4e9 / (b * h * nq * nkv))))
            print(json.dumps({
                "shape": [b, h, nq, nkv, d],
                "layout": "channel-major" if cm else "token-major",
                **split(libs, entry, raw, iters)}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
