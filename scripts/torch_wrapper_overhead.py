#!/usr/bin/env python3
"""Host time a launch through each serving kernel's wrapper, and ENet's ms
a frame, on the card.

Each of the four serving kernels is called through its Python wrapper
(argument checks, then the launch) at the main path's shapes, back to back
in a chain of ``--calls`` calls that ends in one device sync: ``host_us``
is the mean time a call takes to return (the host's cost of a launch; the
queue of launches does not fill in one chain), ``wall_us`` the chain's
wall time a call and ``device_us`` its device time a call (CUDA events).  Then ``build_engine("enet_fused")`` (bf16,
seeded, 512x256) through ``Pipeline`` on synthetic 640x480 frames: ms a
frame, host clock around ``pipe(frame)`` and the grid's copy to the host.

    python3 scripts/torch_wrapper_overhead.py [--calls 400] [--repeats 5]
        [--frames 64]

It uses only the wrappers' and the pipeline's public signatures, so the
same file times an older tree of the port when copied into that tree's
``scripts/``.  Prints one JSON line; each kernel's numbers are medians
over ``--repeats`` chains.
"""

import argparse
import json
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])


def chain_us(fn, calls: int, repeats: int) -> dict:
    """Host, wall and device microseconds a call of ``fn``: the median over
    ``repeats`` chains of ``calls`` calls (after 20 warm ones)."""
    runs = [_chain(fn, calls) for _ in range(repeats)]
    return {k: float(np.median([r[k] for r in runs])) for k in runs[0]}


def _chain(fn, calls: int) -> dict:
    import torch

    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    host = 0.0
    t = time.perf_counter()
    start.record()
    for _ in range(calls):
        s = time.perf_counter()
        fn()
        host += time.perf_counter() - s
    stop.record()
    stop.synchronize()
    wall = time.perf_counter() - t
    return {"host_us": 1e6 * host / calls, "wall_us": 1e6 * wall / calls,
            "device_us": 1e3 * start.elapsed_time(stop) / calls}


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--calls", type=int, default=400)
    p.add_argument("--repeats", type=int, default=5)
    p.add_argument("--frames", type=int, default=64)
    p.add_argument("--label", default="")
    args = p.parse_args()

    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    from bugcar_image_segmentation_tpu_torch.ops.cuda.attention import (
        flash_attention, flash_attention_t)
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import (
        fused_bottleneck, pack_weights)
    from bugcar_image_segmentation_tpu_torch.ops.cuda.sepconv import \
        fused_sepconv

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0, dtype=torch.float32):
        return torch.as_tensor(rng.standard_normal(shape) * scale,
                               dtype=torch.float32, device=dev).to(dtype)

    out = {"label": args.label, "calls": args.calls,
           "nvidia_smi": subprocess.run(
               ["nvidia-smi", "--query-gpu=name,power.limit",
                "--format=csv,noheader"], capture_output=True,
               text=True).stdout.strip()}
    bf = torch.bfloat16
    with torch.no_grad():
        # row 1: a regular trunk block at 1x32x64x128, weights packed once
        c, m = 128, 32
        wp, wc, we = t(c, m, scale=0.1), t(3, 3, m, m, scale=0.06), \
            t(m, c, scale=0.1)
        vec = [t(k).abs() * 0.2 + 0.5 for k in (m, m, m, m, m, m, c, c, c)]
        packed = pack_weights(wp, wc, we)
        state = {"x": t(1, 32, 64, c, dtype=bf)}

        def bottleneck():
            state["x"] = fused_bottleneck(
                state["x"], wp, vec[0], vec[1], vec[2], wc, vec[3], vec[4],
                vec[5], we, vec[6], vec[7], vec[8], kind="regular",
                dilation=1, packed=packed)
        out["fused_bottleneck"] = chain_us(bottleneck, args.calls, args.repeats)

        # rows 2-3: SegFormer-B0's stage 0 and stage 1 at 1024x1024
        q0, k0, v0 = t(1, 1, 65536, 32, dtype=bf), t(1, 1, 1024, 32,
                                                     dtype=bf), \
            t(1, 1, 1024, 32, dtype=bf)
        out["flash_attention"] = chain_us(
            lambda: flash_attention(q0, k0, v0), args.calls, args.repeats)
        q1, k1, v1 = t(1, 2, 32, 16384, dtype=bf), t(1, 2, 32, 1024,
                                                     dtype=bf), \
            t(1, 2, 32, 1024, dtype=bf)
        out["flash_attention_t"] = chain_us(
            lambda: flash_attention_t(q1, k1, v1), args.calls, args.repeats)

        # row 4: a middle-flow site of Xception at 1024x512 (32x64x728)
        cx = 728
        xs = t(1, 32, 64, cx, dtype=bf)
        sargs = (t(3, 3, 1, cx, scale=0.3), t(cx).abs() + 0.5,
                 t(cx, scale=0.1), t(cx, cx, scale=0.04).to(bf),
                 t(cx).abs() + 0.5, t(cx, scale=0.1))
        out["fused_sepconv"] = chain_us(
            lambda: fused_sepconv(xs, *sargs, strides=1, act_out=True),
            args.calls, args.repeats)

        kcuda.reset_launches()
        eng = port.build_engine("enet_fused", port.ModelConfig(
            name="enet_fused"), variables=random_enet_variables(0))
        pipe = port.Pipeline(eng, toy_calibration((256, 512)),
                             port.GridConfig(8.0, 8.0, 0.1))
        frames = [f for f, _, _ in synthetic.video(
            seed=0, num_frames=args.frames, shape=(480, 640))]
        for f in frames[:4]:
            pipe(f).cpu()
        ms = []
        for f in frames:
            s = time.perf_counter()
            pipe(f).cpu()
            ms.append(1e3 * (time.perf_counter() - s))
        out["enet_fused_ms_per_frame"] = dict(zip(
            ("q25", "median", "q75"),
            np.percentile(ms, [25, 50, 75]).tolist()))
        out["enet_fused_launches"] = kcuda.LAUNCHES["fused_bottleneck"]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
