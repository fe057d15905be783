#!/usr/bin/env python3
"""Where the time of the PyTorch port's main path goes, on one NVIDIA GPU.

    python3 scripts/torch_profile_path.py [--frames 8]

from the root of a checkout, on the GPU host.  It builds the engines and
the pipeline as ``chip_smoke.py`` does (seeded weights through the weight
bridge, the toy calibration, synthetic 640x480 frames, ENet 512x256 bf16,
grid 8 m x 8 m at 0.1 m) and prints one JSON line per engine
("enet_fused", "enet") and measurement:

- ``stages``: wall milliseconds per stage of one frame — upload,
  preprocess, encode (stem + stage 1 + the stage-2 down block), trunk (the
  16 stage-2/3 bottlenecks), decode (stages 4-5 + head), remap, grid,
  download — with a device sync after each, averaged over the frames;
- ``profile``: ``torch.profiler`` over ``pipe(frame)`` for the frames:
  wall and device-busy milliseconds per frame (the union of the device
  activity intervals), the device's idle share, kernel launches per frame,
  and the kernels that take the most device time.

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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.models import remap
    from bugcar_image_segmentation_tpu_torch.models.api import \
        frames_to_device
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    variables = random_enet_variables(0)
    frames = [f for f, _, _ in synthetic.video(
        seed=0, num_frames=args.frames, shape=(480, 640))]
    cfg = port.ModelConfig()
    cal = toy_calibration((cfg.input_height, cfg.input_width))
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)

    for name in ("enet_fused", "enet"):
        eng = port.build_engine(name, port.ModelConfig(name=name),
                                variables=variables, device="cuda")
        pipe = port.Pipeline(eng, cal, grid_cfg)
        enet = eng.module

        def trunk(x):
            if name == "enet":
                return enet.trunk(x)
            y = x.permute(0, 2, 3, 1).contiguous()
            for blk in eng.forward_fn.blocks:
                y = blk(y)
            return y.permute(0, 3, 1, 2)

        stages = defaultdict(float)

        @torch.no_grad()
        def one_frame(frame, record):
            state = {}

            def stage(label, fn):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                if record:
                    stages[label] += 1e3 * (time.perf_counter() - t0)
                return out

            f = stage("upload", lambda: frames_to_device(frame[None],
                                                         eng.device))
            x = stage("preprocess", lambda: pre.preprocess_for_config(f, cfg))
            x, state["i1"], state["i2"] = stage("encode",
                                                lambda: enet.encode(x))
            x = stage("trunk", lambda: trunk(x))
            logits = stage("decode", lambda: enet.decode(x, state["i1"],
                                                         state["i2"]))
            seg = stage("remap", lambda: remap.logits_to_drivability(
                logits, eng.remap_table))
            grid = stage("grid", lambda: pipe.builder.build(seg))
            return stage("download", lambda: grid.cpu())

        for f in frames[:2]:
            one_frame(f, record=False)
            pipe(f).cpu()
        for f in frames:
            one_frame(f, record=True)
        n = len(frames)
        print(json.dumps({"engine": name, "measure": "stages",
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
        top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
        print(json.dumps({
            "engine": name, "measure": "profile", "frames": n,
            "wall_ms_per_frame": wall_us / n / 1e3,
            "device_busy_ms_per_frame": busy_us / n / 1e3,
            "device_idle_share": 1.0 - busy_us / wall_us,
            "device_events_per_frame": len(device) / n,
            "top_device_time": [
                {"name": k[:90], "us_per_frame": v[0] / n,
                 "count_per_frame": v[1] / n} for k, v in top],
            "nvidia_smi": smi}), flush=True)

    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
