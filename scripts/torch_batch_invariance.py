#!/usr/bin/env python3
"""Does one frame's result depend on the batch it runs in?  On one NVIDIA GPU.

    python3 scripts/torch_batch_invariance.py [--engine segformer_b0]
                                              [--frames 4]

from the root of a checkout, on the GPU host.  It builds the engine as
``chip_smoke.py`` does (seeded weights, bf16 activations, the engine's
default input size, synthetic 640x480 frames), runs frame 0 alone and
frame 0 inside a batch of ``--frames``, with a forward hook on every
submodule of the backbone, and prints one JSON line per setting:

- the first module, in the order the modules finish, whose output for
  frame 0 differs between the two runs, and how many modules differ;
- the share of equal labels (argmax of the logits) and of equal 3-class
  drivability pixels between the two runs;
- the engine's ``frame_by_frame`` switch (see ``models/api.py``) and the
  library settings it was run with.

Settings: the engine's forward as it is; the backbone taking the whole
batch in one call, under PyTorch's default bf16 reduced-precision GEMM
reductions and with them disallowed; and float32 with TF32 off.  Then one
``timing`` line: the milliseconds of the engine's forward over the batch
(host clock, ending in a device sync, median of 10) frame by frame and
whole, taking turns.  Last it prints
the nvidia-smi name/power-limit line.  Exits non-zero without a CUDA
device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def first_divergence(eng, x, n):
    """Frame 0 of ``x`` alone and inside the first ``n`` frames of ``x``:
    (names of the modules whose frame-0 output differs, in the order the
    modules finish; number of modules hooked; the two runs' logits)."""
    import torch

    outs = {}
    order = []

    def hook(name):
        def record(_mod, _inp, out):
            if isinstance(out, torch.Tensor) and out.dim() >= 1:
                outs.setdefault(name, []).append(out[:1].detach().clone())
                if name not in order:
                    order.append(name)
        return record

    handles = [m.register_forward_hook(hook(name))
               for name, m in eng.module.named_modules() if name]
    try:
        with torch.no_grad():
            alone = eng.forward_fn(x[:1])
            batch = eng.forward_fn(x[:n])
    finally:
        for h in handles:
            h.remove()
    differ = [name for name in order
              if len(outs[name]) == 2 and outs[name][0].shape
              == outs[name][1].shape
              and not torch.equal(outs[name][0], outs[name][1])]
    return differ, len(order), alone, batch[:1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engine", default="segformer_b0")
    ap.add_argument("--frames", type=int, default=4)
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_batch_invariance: no CUDA device", file=sys.stderr)
        return 2
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.models import remap

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    frames = torch.as_tensor(np.stack(
        [f for f, _, _ in synthetic.video(seed=0, num_frames=args.frames,
                                          shape=(480, 640))])).cuda()
    matmul = torch.backends.cuda.matmul

    @contextlib.contextmanager
    def reduced(flag):
        old = matmul.allow_bf16_reduced_precision_reduction
        matmul.allow_bf16_reduced_precision_reduction = flag
        try:
            yield
        finally:
            matmul.allow_bf16_reduced_precision_reduction = old

    settings = [("as_built", "bfloat16", None),
                ("whole_batch", "bfloat16", True),
                ("whole_batch_no_reduced_precision", "bfloat16", False),
                ("whole_batch_f32", "float32", None)]
    base = port.build_engine(args.engine, device="cuda")
    for label, dtype, flag in settings:
        eng = (base if dtype == "bfloat16" else port.build_engine(
            args.engine, dataclasses.replace(base.cfg, dtype=dtype),
            device="cuda"))
        ctx = reduced(flag) if flag is not None else contextlib.nullcontext()
        with ctx, torch.no_grad():
            if label == "as_built":
                alone = eng.forward(frames[:1])
                batch = eng.forward(frames)[:1]
                differ, hooked = [], 0
            else:
                x = pre.preprocess_for_config(frames, eng.cfg)
                differ, hooked, alone, batch = first_divergence(
                    eng, x, args.frames)
        la, lb = alone.argmax(-1), batch.argmax(-1)
        da = remap.logits_to_drivability(alone, eng.remap_table)
        db = remap.logits_to_drivability(batch, eng.remap_table)
        print(json.dumps({
            "engine": args.engine, "setting": label, "dtype": dtype,
            "frame_by_frame": eng.frame_by_frame,
            "allow_bf16_reduced_precision_reduction":
                matmul.allow_bf16_reduced_precision_reduction
                if flag is None else flag,
            "frames": args.frames, "modules_hooked": hooked,
            "modules_differing": len(differ),
            "first_differing": differ[:6],
            "max_abs_logit_diff": float((alone - batch).abs().max()),
            "label_agree": float((la == lb).float().mean()),
            "drivability_agree": float((da == db).float().mean()),
            "nvidia_smi": smi}), flush=True)

    default = base.frame_by_frame

    def forward_ms(invariant):
        base.frame_by_frame = invariant
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with torch.no_grad():
            base.forward(frames)
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0)

    times = {True: [], False: []}
    for r in range(12):
        for invariant in ((True, False) if r % 2 else (False, True)):
            times[invariant].append(forward_ms(invariant))
    base.frame_by_frame = default
    print(json.dumps({
        "engine": args.engine, "measure": "timing", "frames": args.frames,
        "forward_ms_median_frame_by_frame": statistics.median(
            times[True][2:]),
        "forward_ms_median_whole_batch": statistics.median(times[False][2:]),
        "nvidia_smi": smi}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
