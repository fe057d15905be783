#!/usr/bin/env python3
"""Where a fused_sepconv launch spends its time, phase by phase, on one
NVIDIA GPU.

    python3 scripts/torch_sepconv_split.py

from the root of a checkout, on the GPU host.  The card's profilers that
count stalls do not run there, so this script builds variants of
``csrc/fused_sepconv.cu`` with plain nvcc (into ``build/sepconv_split/``),
each with one phase of the bf16 kernel switched off: the input window's
cp.async loads, the depthwise arithmetic (and with it y1's stores), the
cluster exchange (y1 stored to this CTA only), the pointwise phase
(weight ring, products and epilogue) and the epilogue's stores alone.  It
times each with CUDA events (bare launches through the C launcher, bf16,
N = 1, seeded data, the launch plan of ``ops/cuda/sepconv.plan``) at the
Xception path's site shapes at 1024x512 and prints one JSON line per
shape: ``kernel_us`` and ``phase_us``, the time each phase adds (the
kernel's time less the variant's; phases overlap, so these are the
exposed shares and need not sum to the total), then the nvidia-smi
name/power-limit line.  A variant's output is wrong by design; only its
time is read.  Exits non-zero without a CUDA device.
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
                      "fused_sepconv.cu")
OUT = os.path.join(REPO, "build", "sepconv_split")
# variant -> [(text of the source, its replacement), ...]; the phase a
# variant switches off is the difference between the kernel and it.
VARIANTS = {
    "kernel": [],
    "window_load": [
        ("        cp_async16(wdst + cv * plane + (wy * wc + win_slot(wx,"
         " stride)) * 16,",
         "        if (act_out < 0) cp_async16(wdst + cv * plane + (wy * wc +"
         " win_slot(wx, stride)) * 16,")],
    "depthwise": [("    if (cv < kDwChunk / 8 && c0 + 8 * cv < c_hi) {",
                   "    if (act_out < 0 && cv < kDwChunk / 8 && c0 + 8 * cv <"
                   " c_hi) {")],
    "cluster_exchange": [
        ("          *reinterpret_cast<uint4*>(cluster.map_shared_rank(dst, r))"
         " = packed;",
         "          *reinterpret_cast<uint4*>(dst) = packed;")],
    "pointwise": [("  const int steps = (ft_hi - ft_lo + 1) / 2 * nk;",
                   "  const int steps = act_out < 0 ? (ft_hi - ft_lo + 1) / 2"
                   " * nk : 0;")],
    "epilogue": [("      if (oy >= pl.ho || ox >= pl.wo || fi >= f_end) continue;",
                  "      if (oy >= pl.ho || ox >= pl.wo || fi >= f_end ||"
                  " act_out >= 0) continue;")],
}
# (site, H, W, C, F, stride, act_out): the path's shapes at 1024x512
SITES = [("block1.sep0", 256, 512, 64, 128, 1, True),
         ("block1.sep1", 256, 512, 128, 128, 1, True),
         ("block1.sep2", 256, 512, 128, 128, 2, False),
         ("block2.sep0", 128, 256, 128, 256, 1, True),
         ("block2.sep1", 128, 256, 256, 256, 1, True),
         ("block3.sep0", 64, 128, 256, 728, 1, True),
         ("block3.sep1", 64, 128, 728, 728, 1, True),
         ("middle", 32, 64, 728, 728, 1, True)]


def build(nvcc: str, variants=VARIANTS) -> dict:
    """The variants' libraries (name -> ctypes library), compiled in
    parallel."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
    os.makedirs(OUT, exist_ok=True)
    text = open(SOURCE).read()
    procs = []
    for name, subs in variants.items():
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
    for name, so, proc in procs:
        out, _ = proc.communicate(timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{out[-3000:]}")
        lib = ctypes.CDLL(so)
        lib.bugcar_fused_sepconv.argtypes = ([ctypes.c_void_p] * 8
                                             + [ctypes.c_int] * 11
                                             + [ctypes.c_void_p])
        lib.bugcar_fused_sepconv.restype = ctypes.c_int
        libs[name] = lib
    return libs


def split(libs: dict, raw: tuple, iters: int = 100) -> dict:
    """``kernel_us`` and ``phase_us`` of one launch (its C arguments)."""
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
        err = lib.bugcar_fused_sepconv(*raw)
        if err:
            raise RuntimeError(f"{name}: CUDA error {err}")
        times[name] = us(lambda lib=lib: lib.bugcar_fused_sepconv(*raw))
    return {"kernel_us": times["kernel"],
            "phase_us": {k: times["kernel"] - v for k, v in times.items()
                         if k != "kernel"}}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("torch_sepconv_split: no CUDA device", file=sys.stderr)
        return 2
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
    from bugcar_image_segmentation_tpu_torch.ops.cuda import sepconv as sc

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    libs = build(kbuild._nvcc())

    gen = torch.Generator(device="cuda").manual_seed(0)
    for site, h, w, c, f, stride, act in SITES:
        def rnd(*shape):
            return torch.randn(*shape, device="cuda", generator=gen)

        x = rnd(1, h, w, c).bfloat16()
        args = [rnd(3, 3, 1, c) * 0.3, rnd(c).abs() + 0.5, rnd(c) * 0.1,
                (rnd(c, f) / c ** 0.5).bfloat16(), rnd(f).abs() + 0.5,
                rnd(f) * 0.1]
        out = torch.empty(1, h // stride, w // stride, f, device="cuda",
                          dtype=torch.bfloat16)
        raw = sc.launch_args(x, out, *args, strides=stride, act_out=act)
        pl = sc.plan(h, w, c, f, stride)
        print(json.dumps({
            "site": site, "shape": [h, w, c, f], "stride": stride,
            "plan": {"tile_rows": pl.tile_rows, "cluster": pl.cluster,
                     "stages": pl.stages, "ctas": pl.cluster * pl.tiles_h
                     * pl.tiles_w},
            **split(libs, raw), "nvidia_smi": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
