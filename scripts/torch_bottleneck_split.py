#!/usr/bin/env python3
"""What the bf16 fused bottleneck's exact roundings cost, on one NVIDIA GPU.

    python3 scripts/torch_bottleneck_split.py

from the root of a checkout, on the GPU host.  The bf16 kernel
(``csrc/fused_bottleneck.cu``, ``fused_bottleneck_mma``) sums on the tensor
cores, settles each bf16 rounding with an error bound and queues the
elements the bound cannot settle for the FMA chain to recompute.  The
card's profilers that count stalls do not run there, so this script builds
variants of the source with plain nvcc (into ``build/bottleneck_split/``):
``no_fixups`` skips the queued recomputations, ``no_settle`` rounds every
sum as it is (no bound, nothing queued; the error terms are then dead
code); ``counted`` is the kernel with a counter of the queued elements of
each rounding point.  It times each with CUDA events (bare launches
through the C launcher, N = 1) on the trunk activations of a seeded ENet
(``random_enet_variables(0)``, synthetic frame 0, each block fed the plain
version's output of the block before, as chip_smoke.py's kernels phase
does) and prints one JSON line per trunk block: ``kernel_us``, what each
switched-off part adds (``part_us``: the kernel's time less the
variant's), the elements queued at each rounding point (y1, the 5x1
result, y2, the output) and their share of the elements rounded there
(for y1 of the y1 tiles' elements, rows off the image included, so a
lower bound); then the means, then the nvidia-smi name/power-limit
line.  A variant's output is wrong by design;
only its time is read.  Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

SOURCE = os.path.join(REPO, "bugcar_image_segmentation_tpu_torch", "csrc",
                      "fused_bottleneck.cu")
OUT = os.path.join(REPO, "build", "bottleneck_split")
_FIX_LOOPS = [(f"i < nfix[{k}]; i += kMmaThreads", "i < 0; i += kMmaThreads")
              for k in range(4)]
_COUNTER = [
    ("namespace {\n\nconstexpr int kC", "__device__ int g_queued[4];\n"
     "namespace {\n\nconstexpr int kC"),
    ("  __nv_bfloat16* orow = out + ((size_t)n * h + r) * w * kC;",
     "  if (tid < 4) atomicAdd(&g_queued[tid], nfix[tid]);\n"
     "  __nv_bfloat16* orow = out + ((size_t)n * h + r) * w * kC;"),
    ("}  // extern \"C\"", "int bugcar_queued(int* out) {\n"
     "  cudaError_t err = cudaMemcpyFromSymbol(out, g_queued, 4 * sizeof(int));\n"
     "  const int zero[4] = {0, 0, 0, 0};\n"
     "  return err ? (int)err : (int)cudaMemcpyToSymbol(g_queued, zero, "
     "sizeof(zero));\n}\n\n}  // extern \"C\"")]
# variant -> [(text of the source, its replacement), ...]
VARIANTS = {
    "kernel": [],
    "no_fixups": _FIX_LOOPS,
    "no_settle": [("  return unsure && e != 0.f ? kUnsure : bl;",
                   "  return bf16_bits(finish<kP>(pre_act<kP>(acc, s, b, r), "
                   "a));")],
    "counted": _COUNTER,
}


def build(nvcc: str) -> dict:
    """The variants' libraries (name -> ctypes library), compiled in
    parallel."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
    os.makedirs(OUT, exist_ok=True)
    text = open(SOURCE).read()
    procs = []
    for name, subs in VARIANTS.items():
        src = text
        for old, new in subs:
            if src.count(old) != 1:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old!r} exactly once")
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
    ref = kbuild.library().bugcar_fused_bottleneck
    for name, so, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(so)
        lib.bugcar_fused_bottleneck.argtypes = ref.argtypes
        lib.bugcar_fused_bottleneck.restype = ctypes.c_int
        libs[name] = lib
    return libs


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_bottleneck_split: no CUDA device", file=sys.stderr)
        return 2
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.ops.cuda import bottleneck as bn
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    libs = build(kbuild._nvcc())

    def us(fn, iters=200):
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

    frames = [f for f, _, _ in synthetic.video(seed=0, num_frames=1,
                                                 shape=(480, 640))]
    eng = port.build_engine("enet_fused", port.ModelConfig(name="enet_fused"),
                            variables=random_enet_variables(0), device="cuda")
    counted = libs["counted"]
    queued = (ctypes.c_int * 4)()
    means = {}
    blocks = eng.forward_fn.blocks
    with torch.no_grad():
        x = pre.preprocess_for_config(torch.as_tensor(frames[0][None]).cuda(),
                                      eng.cfg)
        x, _, _ = eng.module.encode(x)
        x = x.permute(0, 2, 3, 1).contiguous()
        _, h, w, c = x.shape
        for i, blk in enumerate(blocks):
            args = (blk.wp, blk.s1, blk.b1, blk.a1, blk.wcore(), blk.s2,
                    blk.b2, blk.a2, blk.we, blk.s3, blk.b3, blk.ao)
            kw = dict(kind=blk.kind, dilation=blk.dilation)
            out = torch.empty_like(x)
            raw, _keep = bn.launch_args(x, out, *args, **kw,
                                        packed=blk.packed)
            times = {name: us(lambda lib=lib: lib.bugcar_fused_bottleneck(*raw))
                     for name, lib in libs.items() if name != "counted"}
            kbuild.check(counted.bugcar_queued(queued), "counter")
            kbuild.check(counted.bugcar_fused_bottleneck(*raw), "counted")
            kbuild.check(counted.bugcar_queued(queued), "counter")
            pl = bn.plan(1, h, w, blk.kind, blk.dilation)
            tile = pl["ctas"] * 32 * pl["y1_tile"][0] * pl["y1_tile"][1]
            elems = [tile, pl["ctas"] * 20 * 32 if blk.kind == "asymmetric"
                     else 0, h * w * 32, h * w * c]
            rec = {"block": i, "kind": blk.kind, "dilation": blk.dilation,
                   "kernel_us": times["kernel"],
                   "part_us": {k: times["kernel"] - v for k, v in times.items()
                               if k != "kernel"},
                   "queued": list(queued),
                   "queued_share": {
                       k: (q / e if e else None) for k, q, e in
                       zip(("y1", "z", "y2", "out"), queued, elems)}}
            for key in ("kernel_us",):
                means[key] = means.get(key, 0.0) + rec[key] / len(blocks)
            for k, v in rec["part_us"].items():
                means[k + "_us"] = means.get(k + "_us", 0.0) + v / len(blocks)
            print(json.dumps(rec), flush=True)
            x = bn.fused_bottleneck_ref(x, *args, **kw)
    print(json.dumps({"mean": means, "nvidia_smi": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
