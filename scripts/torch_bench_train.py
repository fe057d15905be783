#!/usr/bin/env python3
"""Training throughput (images a second) of the port's backbones, from
the slope between two chain lengths.

The port's counterpart of scripts/bench_train.py, with its flags and
training resolutions: for each model and batch it chains real AdamW
steps (``training.make_train_step``; the loss perturbs the next batch's
images, so no step repeats the last) at two iteration counts, each run
once to warm up (cuDNN's algorithm choice, the allocator) and then timed
best of three, CUDA-synchronised; the slope between the two counts is
the time of a step, free of the fixed costs.  The JAX script scans the
steps in one compiled program instead.  It prints, per model and batch,
ms a step, images a second and the peak memory of the device; a batch
that runs out of memory is reported and the sweep moves on.

  python scripts/torch_bench_train.py [--models enet unet] \\
      [--batches 8 16] [--iters 4 12] [--remat] [--device cpu]

Models are engine names (``enet``, ``unet``, ``deeplab``,
``segformer_b0``-``_b3``, ``[deeplab_]xception[...]``), built in f32
with the compute in bf16, as scripts/torch_train.py trains.  It runs on
the card unless ``--device cpu`` is given; :func:`run` returns the
records for in-process callers.
"""

import argparse
import subprocess
import sys
import time

sys.path.insert(0, __file__.rsplit("/scripts/", 1)[0])

# scripts/bench_train.py's training resolutions, (H, W): the serving ones,
# except the 1024-class, where batch x resolution x gradients would fill
# the device's memory for nothing
SHAPES = {"enet": (256, 512), "unet": (256, 512), "deeplab": (512, 1024),
          "segformer_b0": (512, 512), "segformer_b2": (512, 512)}
DEFAULT_HW = (256, 512)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--models", nargs="+",
                   default=("enet", "unet", "deeplab", "segformer_b0"))
    p.add_argument("--batches", type=int, nargs="+", default=(8,))
    p.add_argument("--iters", type=int, nargs=2, default=(4, 12))
    p.add_argument("--remat", action="store_true",
                   help="recompute the forward in the backward "
                        "(torch.utils.checkpoint: FLOPs for memory)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    if args.iters[1] <= args.iters[0]:
        p.error("--iters N1 N2 needs N2 > N1")
    return args


def make_model(name: str, num_classes: int = 15):
    """The port's trainable module for an engine name, f32."""
    from bugcar_image_segmentation_tpu_torch.models import api
    from bugcar_image_segmentation_tpu_torch.models.deeplab import DeepLabV3
    from bugcar_image_segmentation_tpu_torch.models.enet import ENet
    from bugcar_image_segmentation_tpu_torch.models.segformer import \
        SegFormer
    from bugcar_image_segmentation_tpu_torch.models.unet import UNet
    from bugcar_image_segmentation_tpu_torch.models.xception import \
        Xception65DeepLab

    head = {True: "quarter", False: "full"}
    if api._is_segformer(name):
        size, quarter, int8, cascade = api.segformer_variant(name)
        return SegFormer.preset(size, num_classes=num_classes,
                                head_upsample=head[quarter], quant=int8,
                                head_cascade=cascade)
    if api._is_xception(name):
        quarter, int8, fused = api.xception_variant(name)
        return Xception65DeepLab(num_classes, head_upsample=head[quarter],
                                 fused_sepconv=fused, pw_int8=int8)
    if name in api.DEEPLAB:
        return DeepLabV3(num_classes, head[name == "deeplab_q"])
    if name in api.UNETS:
        return UNet(num_classes)
    if name in api.EXECUTORS:
        return ENet(num_classes)
    raise SystemExit(f"unknown model {name!r}")


def device_line(device: str) -> str:
    """The card's name and power limit as nvidia-smi prints them, or the
    torch device."""
    if device != "cuda":
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError):
        import torch
        return torch.cuda.get_device_name(0)


def bench(name: str, batch: int, hw, iters, remat: bool, device) -> dict:
    """One model at one batch: the record (or ``failed``)."""
    import numpy as np
    import torch

    from bugcar_image_segmentation_tpu_torch.training import (
        AdamW, create_train_state, make_train_step)

    cuda = device.type == "cuda"
    model = make_model(name)
    model.compute_dtype = torch.bfloat16
    rec = {"model": name, "batch": batch, "input_hw": list(hw)}
    try:
        state = create_train_state(model, (1,) + tuple(hw) + (3,),
                                   optimizer=AdamW(1e-3), device=device)
        step = make_train_step(model, remat=remat)
        rng = np.random.default_rng(0)
        images = torch.as_tensor(rng.uniform(0, 1, (batch,) + tuple(hw)
                                             + (3,)), dtype=torch.bfloat16,
                                 device=device)
        labels = torch.as_tensor(rng.integers(0, 15, (batch,) + tuple(hw)),
                                 device=device)
        gen = torch.Generator().manual_seed(0)

        def chain(n):
            nonlocal state
            img = images
            for _ in range(n):
                state, loss = step(state, img, labels, gen)
                img = img + (loss * 1e-6).to(img.dtype)
            if cuda:
                torch.cuda.synchronize(device)
            return float(loss)

        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        best = []
        for n in iters:
            chain(n)                    # warm-up
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                loss = chain(n)
                times.append(time.perf_counter() - t0)
            best.append(min(times))
        if not np.isfinite(loss):
            raise RuntimeError(f"loss {loss} is not finite")
    except (torch.cuda.OutOfMemoryError, RuntimeError) as exc:
        rec["failed"] = str(exc).splitlines()[0][:200]
        return rec
    finally:
        del model
        if cuda:
            torch.cuda.empty_cache()
    dt = best[1] - best[0]
    rec["seconds"] = {str(n): t for n, t in zip(iters, best)}
    if cuda:
        rec["max_memory_allocated"] = int(
            torch.cuda.max_memory_allocated(device))
    if dt <= 0:
        rec["failed"] = "slope non-positive (noise); rerun"
        return rec
    rec["ms_per_step"] = 1e3 * dt / (iters[1] - iters[0])
    rec["images_per_s"] = batch / rec["ms_per_step"] * 1e3
    return rec


def line(rec: dict) -> str:
    h, w = rec["input_hw"]
    head = f"{rec['model']:13s} batch {rec['batch']:3d} @ {w}x{h}"
    if "failed" in rec:
        return f"{head}: failed ({rec['failed']})"
    peak = rec.get("max_memory_allocated")
    mem = "n/a" if peak is None else f"{peak / 2 ** 30:.2f} GiB"
    return (f"{head}: {rec['ms_per_step']:8.2f} ms/step  "
            f"{rec['images_per_s']:7.1f} img/s  peak {mem}")


def run(args) -> list:
    """Every (model, batch) record, each printed as it is done."""
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA card here; pass --device cpu")
    device = torch.device(args.device)
    print(f"[torch_bench_train] on {device_line(args.device)}",
          file=sys.stderr, flush=True)
    records = []
    for name in args.models:
        hw = SHAPES.get(name, DEFAULT_HW)
        for batch in args.batches:
            rec = bench(name, batch, hw, tuple(args.iters), args.remat,
                        device)
            print(line(rec), flush=True)
            records.append(rec)
    return records


def main(argv=None) -> int:
    run(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
