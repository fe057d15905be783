#!/usr/bin/env python3
"""Where the time of the PyTorch port's paths goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_path.py
        [--engine enet|segformer_b0|deeplab_xception] [--frames 8]

from the root of a checkout, on the GPU host.  It builds the engines and
the pipeline as ``chip_smoke.py`` does (seeded weights through the weight
bridge, the toy calibration, synthetic 640x480 frames, grid 8 m x 8 m at
0.1 m) and prints one JSON line per engine and measurement:

- ``--engine enet`` (default): ENet 512x256 bf16, engines "enet_fused"
  and "enet"; stages upload, preprocess, encode (stem + stage 1 + the
  stage-2 down block), trunk (the 16 stage-2/3 bottlenecks), decode
  (stages 4-5 + head), remap, grid, download;
- ``--engine segformer_b0``: SegFormer-B0 1024x1024 bf16, attention
  through the kernel ("segformer_b0") and through the plain version
  ("segformer_b0_xla_attention"); stages upload, preprocess, embed (the
  four patch embeddings), blocks (the eight transformer blocks and the
  stage norms; attention is a part of them), head, remap, grid, download;
- ``--engine deeplab_xception``: DeepLabV3+ on Xception-65 1024x512 bf16,
  the 55 entry- and middle-flow sepconvs through the kernel
  ("deeplab_xception_fs") and through the plain convs
  ("deeplab_xception"); stages upload, preprocess, entry (stem and blocks
  1-3), middle (16 blocks), exit, aspp, decode (decoder and head), remap,
  grid, download.

Measurements:

- ``stages``: wall milliseconds per stage of one frame, with a device sync
  after each, averaged over the frames;
- ``profile``: ``torch.profiler`` over ``pipe(frame)`` for the frames:
  wall and device-busy milliseconds per frame (the union of the device
  activity intervals), the device's idle share, kernel launches per frame,
  the device time of the path's hand-written kernels per frame (the fused
  bottleneck for ENet, the attention kernel for SegFormer, the fused
  sepconv for Xception), in all and by template instance, and the kernels
  that take the most device time.

Last it prints the nvidia-smi name/power-limit line.  Exits non-zero
without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def _enet_stages(eng, pipe, stage, frame):
    """One frame through the ENet engine's stages (see the docstring)."""
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.models import remap
    from bugcar_image_segmentation_tpu_torch.models.api import \
        frames_to_device

    enet = eng.module

    def trunk(x):
        if eng.name == "enet":
            return enet.trunk(x)
        y = x.permute(0, 2, 3, 1).contiguous()
        for blk in eng.forward_fn.blocks:
            y = blk(y)
        return y.permute(0, 3, 1, 2)

    f = stage("upload", lambda: frames_to_device(frame[None], eng.device))
    x = stage("preprocess", lambda: pre.preprocess_for_config(f, eng.cfg))
    x, i1, i2 = stage("encode", lambda: enet.encode(x))
    x = stage("trunk", lambda: trunk(x))
    logits = stage("decode", lambda: enet.decode(x, i1, i2))
    seg = stage("remap", lambda: remap.logits_to_drivability(
        logits, eng.remap_table))
    grid = stage("grid", lambda: pipe.builder.build(seg))
    return stage("download", lambda: grid.cpu())


def _segformer_stages(eng, pipe, stage, frame):
    """One frame through the SegFormer engine's stages."""
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.models import remap
    from bugcar_image_segmentation_tpu_torch.models.api import \
        frames_to_device

    m = eng.module
    f = stage("upload", lambda: frames_to_device(frame[None], eng.device))
    x = stage("preprocess", lambda: pre.preprocess_for_config(
        f, eng.cfg).to(m.dtype))
    out_hw = (x.shape[1], x.shape[2])
    feats = []
    for s in range(4):
        t, hw = stage("embed", lambda: m.embed(s, x))
        x = stage("blocks", lambda: m.blocks(s, t, hw))
        feats.append(x)
    logits = stage("head", lambda: m.head(feats, out_hw))
    seg = stage("remap", lambda: eng.to_input_res(
        remap.logits_to_drivability(logits, eng.remap_table)))
    grid = stage("grid", lambda: pipe.builder.build(seg))
    return stage("download", lambda: grid.cpu())


def _xception_stages(eng, pipe, stage, frame):
    """One frame through the Xception engine's stages."""
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.models import remap
    from bugcar_image_segmentation_tpu_torch.models.api import \
        frames_to_device

    m = eng.module
    f = stage("upload", lambda: frames_to_device(frame[None], eng.device))
    x = stage("preprocess", lambda: pre.preprocess_for_config(f, eng.cfg))
    y, low_level = stage("entry", lambda: m.entry(x))
    y = stage("middle", lambda: m.middle(y))
    y = stage("exit", lambda: m.exit_flow(y))
    y = stage("aspp", lambda: m.aspp(y))
    logits = stage("decode", lambda: m.decode(y, low_level,
                                              (x.shape[1], x.shape[2])))
    seg = stage("remap", lambda: eng.to_input_res(
        remap.logits_to_drivability(logits, eng.remap_table)))
    grid = stage("grid", lambda: pipe.builder.build(seg))
    return stage("download", lambda: grid.cpu())


# Device-time names of the port's hand-written kernels, by path (the
# attention source's wgmma and SIMT kernels; the sepconv's bf16 and f32
# kernels; the bottleneck's bf16 and f32 kernels).
KERNEL_NAMES = {"segformer_b0": ("flash_attention_wgmma",
                                 "flash_attention_simt"),
                "deeplab_xception": ("sepconv_bf16", "sepconv_f32"),
                "enet": ("fused_bottleneck_mma", "fused_bottleneck_tile")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine",
                    choices=("enet", "segformer_b0", "deeplab_xception"),
                    default="enet")
    ap.add_argument("--frames", type=int, default=8)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("torch_profile_path: no CUDA device", file=sys.stderr)
        return 2
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
        random_segformer_variables
    from bugcar_image_segmentation_tpu_torch.convert.flax_xception import \
        random_xception_variables
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    frames = [f for f, _, _ in synthetic.video(
        seed=0, num_frames=args.frames, shape=(480, 640))]
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    if args.engine == "enet":
        variables = random_enet_variables(0)
        runs = [(name, name, False) for name in ("enet_fused", "enet")]
        cfg = port.ModelConfig()
        one_frame_stages = _enet_stages
    elif args.engine == "segformer_b0":
        variables = random_segformer_variables(0)
        runs = [("segformer_b0", "segformer_b0", False),
                ("segformer_b0_xla_attention", "segformer_b0", True)]
        cfg = port.ModelConfig(name="segformer_b0", input_width=1024,
                               input_height=1024)
        one_frame_stages = _segformer_stages
    else:
        variables = random_xception_variables(0)
        runs = [(name, name, False) for name in ("deeplab_xception_fs",
                                                 "deeplab_xception")]
        cfg = port.ModelConfig(name="deeplab_xception", input_width=1024,
                               input_height=512)
        one_frame_stages = _xception_stages
    cal = toy_calibration((cfg.input_height, cfg.input_width))

    for label, name, plain_attention in runs:
        eng = port.build_engine(name, cfg, variables=variables,
                                device="cuda")
        if plain_attention:
            eng.module.xla_attention = True
        pipe = port.Pipeline(eng, cal, grid_cfg)
        stages = defaultdict(float)

        @torch.no_grad()
        def one_frame(frame, record):
            def stage(what, fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                if record:
                    stages[what] += 1e3 * (time.perf_counter() - t0)
                return out

            return one_frame_stages(eng, pipe, stage, frame)

        for f in frames[:2]:
            one_frame(f, record=False)
            pipe(f).cpu()
        for f in frames:
            one_frame(f, record=True)
        n = len(frames)
        print(json.dumps({"engine": label, "measure": "stages",
                          "ms_per_frame": {k: v / n for k, v in
                                           stages.items()},
                          "sum_ms": sum(stages.values()) / n,
                          "nvidia_smi": smi}), flush=True)

        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for f in frames:
                pipe(f).cpu()
            wall_us = 1e6 * (time.perf_counter() - t0)
        device = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
        kernels = defaultdict(lambda: [0.0, 0])
        for e in device:
            k = kernels[e.name]
            k[0] += e.time_range.elapsed_us()
            k[1] += 1
        busy_us = _busy_us([(e.time_range.start, e.time_range.end)
                            for e in device])
        per_kernel = {name: sum(v[0] for k, v in kernels.items()
                                if name + "<" in k)
                      for name in KERNEL_NAMES.get(args.engine, ())}
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
        print(json.dumps({
            "engine": label, "measure": "profile", "frames": n,
            "wall_ms_per_frame": wall_us / n / 1e3,
            "device_busy_ms_per_frame": busy_us / n / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "device_events_per_frame": len(device) / n,
            "kernel": KERNEL_NAMES.get(args.engine),
            "kernel_ms_per_frame": sum(per_kernel.values()) / n / 1e3,
            "kernels_ms_per_frame": {k: v / n / 1e3
                                     for k, v in per_kernel.items()},
            # each instance (template arguments: width, layout, kind)
            "instances_ms_per_frame": {
                k[:120]: v[0] / n / 1e3 for k, v in kernels.items()
                if any(name + "<" in k
                       for name in KERNEL_NAMES.get(args.engine, ()))},
            "top_device_time": [
                {"name": k[:90], "us_per_frame": v[0] / n,
                 "count_per_frame": v[1] / n} for k, v in top],
            "nvidia_smi": smi}), flush=True)

    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
