#!/usr/bin/env python3
"""Smoke run of the PyTorch port's paths on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a host with one CUDA card, nvcc and
nvidia-smi.  It imports only ``bugcar_image_segmentation_tpu_torch`` (no
JAX, no Flax, no cv2, no msgpack) and runs, printing one JSON line per
phase with its elapsed seconds:

1. ``env``    — the card, its power limit and top SM clock (nvidia-smi),
   torch / CUDA versions.
2. ``build``  — plain nvcc builds every ``csrc/*.cu`` (one process per
   source, all started together) into one library in ``build/kernels/``.
3. ``kernels``— ``fused_bottleneck`` on every ENet trunk block (all kinds
   and dilations) at the ENet path's shape (N = 1 and 4, 32x64x128, mid
   32), on the real trunk activations of a seeded ENet: in float32 (TF32
   off) held against its plain PyTorch version (frames 0 and 0-3); in
   bfloat16 on five frame sets (0, 0-3, 4-7, 8-11, 12-15) held bit for bit
   to ``fused_bottleneck_chain`` (the kernel's stated arithmetic), and to
   the plain version under the bf16 budget, where each output over it must
   be explained by a flipped ambiguous rounding (``rounds_apart``) and
   their count stays under a cap (``bottleneck_gate`` lines); timed with
   CUDA events; each record carries its launch plan (kernel, CTAs,
   threads, output pixels a CTA, the y1 tile a CTA projects).
4. ``path``   — ``build_engine("enet_fused")`` with seeded weights (a
   Flax-layout numpy tree through the weight bridge) and ``Pipeline`` at
   ENet's full width (512x256, 15 classes) on synthetic 640x480 frames:
   ``pipe(frame)``, ``pipe.stream(frames, depth=2)`` and a 4-frame batch,
   with the kernel's launch count read around exactly that run; grids
   checked for shape, dtype and values, and held against the plain
   ``"enet"`` engine on the card and a float32 CPU run of the port.
5. ``attention_kernels`` — ``flash_attention`` and ``flash_attention_t``
   at SegFormer-B0's four stage shapes at 1024x1024 (d 32, Nkv 1024 after
   the spatial reduction), B2's four (d 64: heads 1, 2, 5, 8) and one
   Nkv = 4096 shape, each held against ``attention_reference`` in
   bfloat16 and in float32 (TF32 off), and timed with CUDA events beside
   the plain version and ``torch.nn.functional.scaled_dot_product_attention``
   (a yardstick, never on the path); each bf16 record carries its launch
   plan (queries and threads a CTA, CTAs).
6. ``segformer_path`` — ``build_engine("segformer_b0")`` (MiT-B0 at
   1024x1024, 15 classes, bf16, seeded weights) and ``Pipeline``:
   ``pipe(frame)``, ``pipe.stream(frames, depth=2)``, a 4-frame batch, and
   ``segformer_b0_q`` through ``interpolation="native"``, with the
   attention launch counts read around exactly that run (8 per backbone
   batch); grids checked, and held against the same weights with the
   plain attention (``xla_attention``) on the card and against a float32
   CPU run of the port; the engines take turns for the speed numbers.
7. ``sepconv_kernels`` — ``fused_sepconv`` at every site shape of the
   Xception path at 1024x512 (and the two stride-2 shapes the path leaves
   to the plain convs), N = 1 and 4, on seeded data, held against
   ``sepconv_reference`` in bfloat16 and in float32 (TF32 off), and timed
   at N = 1 in bf16 with CUDA events beside the plain version; each
   record carries its launch plan and ``phase_us``, the time each phase
   of the launch adds (window load, depthwise, cluster exchange,
   pointwise, epilogue; ``scripts/torch_sepconv_split.py``'s variants).
8. ``xception_path`` — ``build_engine("deeplab_xception_fs")`` (DeepLabV3+
   on Xception-65 at 1024x512, 15 classes, bf16, seeded weights) and
   ``Pipeline``: ``pipe(frame)``, ``pipe.stream(frames, depth=2)``, a
   4-frame batch, and ``deeplab_xception_q_fs`` through
   ``interpolation="native"``, with the kernel's launch count read around
   exactly that run (55 per backbone forward, 0 for the plain engine);
   grids checked, and held against the plain ``"deeplab_xception"`` engine
   on the card and a float32 CPU run of the port; a label histogram shows
   that the seeded weights tell pixels apart; the engines take turns for
   the speed numbers.

9. ``bench_path`` — ``bench.py``'s own path on the port:
   ``build_engine("enet_w16")`` and ``"enet_fused_w16"`` (bf16-rounded
   weights, bf16, seeded) with ``Pipeline(..., host_resize=True,
   transport="i420")`` on 640x480 frames (the host resizes to 512x256 and
   packs I420; the card converts back): the launch counts of its run, p50
   blocking latency over 20 frames, sustained fps over 100 frames
   (``depth=16, sync_chunk=16``) with ``transfer_batch`` 4 and 1 (median
   of 3 passes after a warm pass), the host time of ``_prep_host``, the
   host→device copy, the device-busy time and share of a frame
   (torch.profiler) and the device→host copy; ``stream(transfer_batch=4)``
   over 10 frames (a partial last batch) held equal to the per-frame
   grids, ``enet_fused_w16`` labels against ``enet_w16``'s, and the card's
   f32 ``enet_w16`` against a CPU run of the port.
10. ``probe_kernels`` — ``scripts/torch_probe_strided.py``'s probes (the
   Mosaic probes of ``scripts/probe_mosaic.py``) run once through
   ``strided_gather`` and ``halo_add`` with their launch counts read
   around that run; then each kernel at the probes' (16, 64, 128) shapes
   held bit-equal to its plain version and timed beside it, the PyTorch
   call that computes the same function and its bytes bound.
11. ``deeplab_path`` — ``build_engine("deeplab")`` and ``"deeplab_q"`` (the
   MobileNetV2 DeepLab at 1024x512, 15 classes, bf16, seeded weights;
   ``_q`` on the native grid) through ``Pipeline``: single, stream and
   4-frame batch grids equal, no kernel launched, a label histogram, f32
   on the card against the CPU, device-busy ms per frame and the speed
   numbers.
12. ``unet_path`` — the same for ``build_engine("unet")`` at 512x256 (the
   backbone frame by frame, ``Engine.frame_by_frame``).
13. ``rig_path`` — ``MultiCameraPipeline`` with 4 cameras at 512x256
   (distinct yaws) on ``enet_fused_w16`` (the bottleneck kernel at N = 4)
   and ``enet_w16``, with ``cv2_linear`` and ``native`` grids: the
   stitched grid equal to the max of the per-camera ``Pipeline`` grids,
   the kernel engine's cells against the plain one's, f32 on the card
   against the CPU, rig ms (4 cameras) beside one camera's ms, device
   busy per rig frame.
14. ``grid_options`` — on ``enet_fused`` (bf16): laserscan grids
   (multiclass; binary, a (2, 80, 80) pair), ``use_clahe`` and
   ``contour_filter``, each with single, stream and batch grids equal,
   f32 grids on the card against the CPU, device busy and speed.
15. ``variants_path`` — the serving picks of config 5,
   ``segformer_b2_hc_q`` and ``segformer_b0_hc_q`` (native grid), and the
   int8 engines ``segformer_b2_int8`` (at 1024x1024) and
   ``xception_int8`` (1024x512, 16 middle blocks), bf16, seeded, through
   ``Pipeline``: the attention launch counts of the run (none for
   Xception, whose fused sepconv ``_int8`` turns off), single, stream and
   4-frame batch grids equal, f32 on the card against the CPU (for the
   int8 engines the CPU takes the card's int8 activations at every int8
   product, so that both round alike; the free-running CPU run is
   recorded beside), the bf16
   label share against the same engine without the flag (a record: the
   seeded weights make near-ties), device busy and the speed numbers; at
   every int8 site of a frame ``torch._int_mm`` equal to the exact product
   of the same int8 operands, and timed beside the whole int8 path and a
   bf16 ``F.linear`` of the same (M, K, N) (``int8_site`` lines).
16. ``fusion_path`` — ``segment_frame`` on ``enet_fused_w16`` over 16
   synthetic frames with odometry, the grids fed to ``TemporalGridFusion``
   with the ``"torch"`` backend on the card and the ``"numpy"`` backend:
   fused grids and odds equal, ms an update of each.

Every path's grids of one frame alone, in a batch and in a stream must be
equal, in bf16 too (SegFormer's engines run the backbone frame by frame,
``Engine.frame_by_frame``).  Then it prints the nvidia-smi name/power-limit line, a ``{"kernels": ...}``
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before those lines; a hang turns into a traceback and a non-zero
exit (faulthandler).
"""

from __future__ import annotations

import contextlib
import faulthandler
import importlib.util
import json
import os
import subprocess
import sys
import time

DEADLINE_S = 1000          # the whole run, build included
SEED = 0
FRAME_HW = (480, 640)      # camera frames
STREAM_FRAMES = 16
SPEED_ROUNDS = 8           # turns per engine in the speed measurement
MEM_RATE = 3.35e12         # H100 SXM HBM3, bytes/s
PEAK = {"bfloat16": 989e12, "float32": 67e12}   # dense FLOP/s by input type
SFU_PER_SM_CLK = 16        # exp (MUFU.EX2) per SM per clock
SMS = 132                  # H100 SXM
# kernel vs plain version, |got - ref| <= atol + rtol * |ref|:
TOL = {"float32": (2e-4, 2e-4),      # the JAX package's f32 budget
       "bfloat16": (2 ** -6, 2 ** -5)}  # a few bf16 ulps: rounding points
# flash attention vs attention_reference: float32 2e-5 (the JAX package's
# own attention tolerance); bfloat16 one ulp of the output (both compute in
# f32 from the same operands and round once).
ATTN_TOL = {"float32": (2e-5, 0.0), "bfloat16": (1e-5, 2 ** -7)}
# The bf16 bottleneck gate's frame sets, (first frame, frames): frame 0
# alone, then 0-3, 4-7, 8-11 and 12-15, each block fed the plain version's
# output of the block before (scripts/torch_bottleneck_rounding.py's sets).
# On each the kernel must equal fused_bottleneck_chain bit for bit, and an
# output over TOL["bfloat16"] against the plain version (cuDNN's f32 sums) is
# accepted only at a pixel whose y2 rounds apart, every value that rounds
# apart being ambiguous or fed by one that does (rounds_apart); at most this
# many such outputs on one set (pinned from the five sets on the card).
BOTTLENECK_FRAME_SETS = [(0, 1), (0, 4), (4, 4), (8, 4), (12, 4)]
BOTTLENECK_ATTRIBUTED_CAP = 4     # measured at most 2 (frames 4-7)
# Share of equal labels / grid cells, kernel vs plain engine on the card
# in bf16: the two round at different points (the kernel keeps f32 between
# its stages), so argmax near-ties of the seeded random weights flip; a
# CPU rehearsal of this run measured 0.9936 labels / 0.9949 cells.  The
# same budget holds SegFormer's and Xception's kernel engines against their
# plain versions (card tests at 512x512 / 512x256 pass it).  It is not a
# budget for one engine against itself: a frame's grid alone, in a batch
# and in a stream must be equal (check_batch_invariant).
AGREE_BF16 = 0.98
# The same in f32 (TF32 off), the card's fused engine vs the CPU's plain one.
AGREE_F32 = 0.999
F32_LOGIT_ATOL = 1e-3
# (B, H, Nq, Nkv, d): SegFormer-B0's attention at 1024x1024, stage by
# stage (the path's shapes), then a B1-B3 head dim and the JAX kernel's
# blocked regime (Nkv > 2048).
ATTN_STAGES = [(1, 1, 65536, 1024, 32), (1, 2, 16384, 1024, 32),
               (1, 5, 4096, 1024, 32), (1, 8, 1024, 1024, 32)]
# SegFormer-B2's at 1024x1024: widths (64, 128, 320, 512) over heads (1, 2,
# 5, 8), head dim 64 in every stage
ATTN_B2_STAGES = [(1, 1, 65536, 1024, 64), (1, 2, 16384, 1024, 64),
                  (1, 5, 4096, 1024, 64), (1, 8, 1024, 1024, 64)]
ATTN_EXTRA = [(1, 1, 4096, 4096, 32)]
SEGFORMER_HW = (1024, 1024)
XCEPTION_HW = (512, 1024)  # (H, W): the JAX package's 1024x512 default
# fused_sepconv's site shapes on the Xception path at 1024x512, (name, H,
# W, C, F, stride, act_out, launches per frame); the two last shapes are
# stride-2 sites the path leaves to the plain convs (the JAX gate takes
# stride 2 only at C = 128), held here so that the stride-2 code is held
# at C != 128.
SEP_SITES = [("block1.sep0", 256, 512, 64, 128, 1, True, 1),
             ("block1.sep1", 256, 512, 128, 128, 1, True, 1),
             ("block1.sep2", 256, 512, 128, 128, 2, False, 1),
             ("block2.sep0", 128, 256, 128, 256, 1, True, 1),
             ("block2.sep1", 128, 256, 256, 256, 1, True, 1),
             ("block3.sep0", 64, 128, 256, 728, 1, True, 1),
             ("block3.sep1", 64, 128, 728, 728, 1, True, 1),
             ("middle", 32, 64, 728, 728, 1, True, 48),
             ("block2.sep2 (plain on the path)", 128, 256, 256, 256, 2,
              False, 0),
             ("block3.sep2 (plain on the path)", 64, 128, 728, 728, 2,
              False, 0)]
SEP_PER_FRAME = sum(site[-1] for site in SEP_SITES)     # 55
DEEPLAB_HW = (512, 1024)   # the MobileNetV2 DeepLab's 1024x512 default
UNET_HW = (256, 512)       # UNet's 512x256 default
RIG_YAWS = (-0.6, -0.2, 0.2, 0.6)   # the 4-camera rig's cameras (radians)
RIG_GRIDS = ("cv2_linear", "native")
# bench.py's path: frames in the latency and the sustained runs, passes
BENCH_LATENCY_FRAMES = 20
BENCH_STREAM_FRAMES = 100
BENCH_PASSES = 3
PROFILE_FRAMES = 8
# the Mosaic probes' (R, W, C) and the kernel launches of one run of
# scripts/torch_probe_strided.py (Q1-Q3 f32, Q5-Q5d bf16, Q4)
PROBE_SHAPE = (16, 64, 128)
# The variants path: (engine, the same engine without its flag, input
# (H, W), warp interpolation).  The _hc_q engines are docs/SERVING.md's
# config-5 picks; B2 is widths (64, 128, 320, 512), depths (3, 4, 6, 3),
# SR (8, 4, 2, 1), decoder 768.
VARIANTS = [("segformer_b2_hc_q", "segformer_b2_q", SEGFORMER_HW, "native"),
            ("segformer_b0_hc_q", "segformer_b0_q", SEGFORMER_HW, "native"),
            ("segformer_b2_int8", "segformer_b2", SEGFORMER_HW, "cv2_linear"),
            ("xception_int8", "deeplab_xception", XCEPTION_HW,
             "cv2_linear")]
FUSION_FRAMES = 16
FUSION_PASSES = 8
PROBE_LAUNCHES = {"strided_gather": 4, "strided_gather_bf16": 4,
                  "halo_add": 1}

_T0 = time.perf_counter()


def emit(phase: str, **fields) -> None:
    rec = {"phase": phase, "elapsed_s": round(time.perf_counter() - _T0, 3)}
    rec.update(fields)
    print(json.dumps(rec), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean device milliseconds of fn() over ``iters`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / iters


def quartiles(values) -> dict:
    import numpy as np
    return dict(zip(("q25", "median", "q75"),
                    np.percentile(values, [25, 50, 75]).tolist()))


def speed_turns(runs, frames) -> dict:
    """ms per frame (``pipe(frame)``), stream fps (depth 2) and 4-frame
    batch ms of each (label, pipeline): host clock around work that ends
    in a device sync; the pipelines take turns (a, b, ..., then the
    reverse order) so that drift on the shared host falls on all;
    quartiles over ``SPEED_ROUNDS`` rounds."""
    import numpy as np

    def frame_ms(p, i):
        s = time.perf_counter()
        p(frames[i % len(frames)]).cpu()
        return 1e3 * (time.perf_counter() - s)

    def stream_fps(p):
        s = time.perf_counter()
        out = list(p.stream(iter(frames), depth=2))
        return len(out) / (time.perf_counter() - s)

    def batch_ms(p):
        s = time.perf_counter()
        p.run_batch(np.stack(frames[:4])).cpu()
        return 1e3 * (time.perf_counter() - s)

    samples = {k: {"ms_per_frame": [], "stream_fps": [], "batch4_ms": []}
               for k, _ in runs}
    for r in range(SPEED_ROUNDS):
        for label, p in (runs if r % 2 == 0 else runs[::-1]):
            got = samples[label]
            got["ms_per_frame"] += [frame_ms(p, r * 4 + i) for i in range(4)]
            got["stream_fps"].append(stream_fps(p))
            got["batch4_ms"].append(batch_ms(p))
    return {label: {m: quartiles(v) for m, v in got.items()}
            for label, got in samples.items()}


def backbone_calls(engine, singles: int, *batches: int) -> int:
    """Backbone forwards of ``singles`` one-frame runs and runs of these
    batch sizes: one per frame of a batch when the engine runs frame by
    frame, else one per batch."""
    return singles + sum(n if engine.frame_by_frame else 1 for n in batches)


def check_grids(what: str, grids, want) -> None:
    import numpy as np
    for name, g in grids.items():
        if g.dtype != np.int8 or g.shape[1:] != want:
            fail(f"{what} {name} grids are {g.dtype} {g.shape}, want int8 "
                 f"{want}")
        if not set(np.unique(g).tolist()) <= {-1, 0, 100}:
            fail(f"{what} {name} grid values {np.unique(g)} not in "
                 f"{{-1, 0, 100}}")


def check_batch_invariant(what: str, **shares: float) -> None:
    """A frame's grid alone, in a batch and in a stream must be the same
    (bf16 on the card too; see ``Engine.frame_by_frame``)."""
    if min(shares.values()) < 1.0:
        fail(f"{what}: grids of one frame differ between single, batch and "
             f"stream runs; equal shares {shares}")


@contextlib.contextmanager
def int8_mm_as(fn):
    """Route every ``ops.quant.int8_mm(a, b)`` of the port through
    ``fn(int8_mm, a, b)`` while the block runs."""
    from bugcar_image_segmentation_tpu_torch.ops import quant
    real = quant.int8_mm
    quant.int8_mm = lambda a, b: fn(real, a, b)
    try:
        yield
    finally:
        quant.int8_mm = real


def check_f32_card_vs_cpu(what: str, card, cpu, frame,
                          int8: bool = False) -> dict:
    """f32 logits of one frame from an engine on the card (its kernels,
    TF32 off) against the port's engine on the CPU (the plain versions):
    finite, max |err| <= F32_LOGIT_ATOL, labels >= AGREE_F32; returns the
    phase line's fields.

    ``int8``: the engine quantizes its activations, and an f32 value one
    ulp from a rounding boundary on one side moves one int8 step, so a
    few ulps of the card's and the CPU's other summation orders become
    int8 steps (measured on the CPU against the JAX package too,
    tests/test_torch_segformer_variants.py); so can a folded head's
    weights, composed by another GEMM.  The CPU run then takes the card's
    int8 operands at every int8 product, in call order, which leaves it
    the card's rounding decisions and holds all else to the same budgets;
    the free-running CPU run's labels and the int8 values it rounds the
    other way are recorded beside."""
    import torch
    extra = {}
    with torch.no_grad():
        if int8:
            card_ops = []

            def record(mm, a, b):
                card_ops.append((a, b))
                return mm(a, b)

            with int8_mm_as(record):
                lg_card = card.logits(frame).cpu()
            free = cpu.logits(frame)
            forced = iter(card_ops)
            moved = [0, 0]

            def replay(mm, a, b):
                ops = next(forced, None)
                if ops is None or (ops[0].shape, ops[1].shape) != (
                        a.shape, b.shape):
                    fail(f"{what}: the CPU's int8 products do not follow "
                         f"the card's")
                a_card, b_card = (t.cpu() for t in ops)
                moved[0] += int((a_card != a).sum() + (b_card != b).sum())
                moved[1] += a.numel() + b.numel()
                return mm(a_card, b_card)

            with int8_mm_as(replay):
                lg_cpu = cpu.logits(frame)
            if next(forced, None) is not None:
                fail(f"{what}: the CPU ran fewer int8 products than the card")
            extra = {
                "f32_free_cpu_label_agree": float(
                    (lg_card.argmax(-1) == free.argmax(-1)).float().mean()),
                "f32_free_cpu_max_logit_err": float(
                    (lg_card - free).abs().max()),
                "int8_products": len(card_ops),
                "int8_values_rounded_apart": moved[0],
                "int8_values": moved[1]}
        else:
            lg_card = card.logits(frame).cpu()
            lg_cpu = cpu.logits(frame)
    if not bool(torch.isfinite(lg_card).all()):
        fail(f"{what}: float32 logits on the card are not finite")
    err = float((lg_card - lg_cpu).abs().max())
    agree = float((lg_card.argmax(-1) == lg_cpu.argmax(-1)).float().mean())
    if err > F32_LOGIT_ATOL or agree < AGREE_F32:
        fail(f"{what} f32 on the card vs on the CPU: max |logit err| {err} "
             f"(budget {F32_LOGIT_ATOL}), labels agree {agree} (budget "
             f"{AGREE_F32})")
    return {"f32_card_vs_cpu_max_logit_err": err,
            "f32_card_vs_cpu_label_agree": agree,
            "f32_logit_max": float(lg_cpu.abs().max()), **extra}


def block_bound(n: int, h: int, w: int, kind: str, dtype: str):
    """(least ms, "bytes" | "operations") of one bottleneck launch: x read
    and out written once, f32 weights read once; useful FLOPs at the peak
    rate of the input type."""
    c, mid = 128, 32
    taps = 10 if kind == "asymmetric" else 9
    item = 2 if dtype == "bfloat16" else 4
    flops = 2 * n * h * w * (c * mid + taps * mid * mid + mid * c)
    nbytes = 2 * n * h * w * c * item + 4 * (2 * c * mid + taps * mid * mid
                                             + 6 * mid + 3 * c)
    t_bytes, t_ops = nbytes / MEM_RATE, flops / PEAK[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def attention_bound(shape, dtype: str, clock_hz: float) -> dict:
    """The least time of one attention launch: the larger of the bytes
    (q, k, v read once, out written once) over the memory rate, the two
    products' FLOPs (4·B·H·Nq·Nkv·d) over the tensor rate of the input
    type, and the B·H·Nq·Nkv exps over the SFU rate (16 per SM per clock
    at ``clock_hz``)."""
    b, h, nq, nkv, d = shape
    item = 2 if dtype == "bfloat16" else 4
    t = {"bytes": item * b * h * d * (2 * nq + 2 * nkv) / MEM_RATE,
         "flops": 4 * b * h * nq * nkv * d / PEAK[dtype],
         "exp": b * h * nq * nkv / (SFU_PER_SM_CLK * SMS * clock_hz)}
    worst = max(t, key=t.get)
    return {"bound_ms": 1e3 * t[worst],
            "bound_by": "bytes" if worst == "bytes" else "operations",
            "set_by": worst, **{f"{k}_ms": 1e3 * v for k, v in t.items()}}


def enet_phases(lib, smi: str, dev) -> dict:
    """ENet's phases (``kernels`` and ``path``); returns the kernel line's
    ``fused_bottleneck`` entry."""
    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import (
        fused_bottleneck_chain, fused_bottleneck_ref, launch_args, plan,
        rounds_apart)

    # -- weights, frames, engines --------------------------------------------
    t = time.perf_counter()
    variables = random_enet_variables(SEED)
    frames = [f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=STREAM_FRAMES, shape=FRAME_HW)]
    cfg16 = port.ModelConfig(name="enet_fused")               # bf16, 512x256
    cfg32 = port.ModelConfig(name="enet_fused", dtype="float32")
    eng = {(name, dt): port.build_engine(name, cfg, variables=variables,
                                         device="cuda")
           for name in ("enet_fused", "enet")
           for dt, cfg in (("bfloat16", cfg16), ("float32", cfg32))}
    emit("setup", seconds=round(time.perf_counter() - t, 3),
         frames=len(frames), frame_shape=list(frames[0].shape))

    # -- kernels -------------------------------------------------------------
    t = time.perf_counter()
    per_block = []
    worst = {}
    gates = []
    for dt in ("bfloat16", "float32"):
        fused = eng[("enet_fused", dt)]
        atol, rtol = TOL[dt]
        sets = BOTTLENECK_FRAME_SETS if dt == "bfloat16" else [(0, 1), (0, 4)]
        for f0, n in sets:
            gate = {"frames": [f0, f0 + n], "bits_equal_chain": True,
                    "over_budget_attributed": 0, "apart": {}}
            with torch.no_grad():
                x = pre.preprocess_for_config(
                    torch.as_tensor(np.stack(frames[f0:f0 + n])).to(dev),
                    fused.cfg)
                x, _, _ = fused.module.encode(x)
                x = x.permute(0, 2, 3, 1).contiguous()   # trunk input, NHWC
                for i, blk in enumerate(fused.forward_fn.blocks):
                    args = (blk.wp, blk.s1, blk.b1, blk.a1, blk.wcore(),
                            blk.s2, blk.b2, blk.a2, blk.we, blk.s3, blk.b3,
                            blk.ao)
                    kw = dict(kind=blk.kind, dilation=blk.dilation)
                    what = (f"fused_bottleneck {blk.kind} d={blk.dilation} "
                            f"{dt} frames {f0}-{f0 + n - 1} (block {i})")
                    got = blk(x)
                    ref = fused_bottleneck_ref(x, *args, **kw)
                    torch.cuda.synchronize()
                    diff = (got.float() - ref.float()).abs()
                    over = diff > atol + rtol * ref.float().abs()
                    err = float(diff.max())
                    if not bool(torch.isfinite(got.float()).all()):
                        fail(f"{what}: output not finite")
                    if dt == "float32" and bool(over.any()):
                        fail(f"{what}: max |err| {err} exceeds {atol} + "
                             f"{rtol}*|ref|")
                    if dt == "bfloat16":
                        # (a) the kernel's stated arithmetic, bit for bit
                        chain = fused_bottleneck_chain(x, *args, **kw)
                        bits = int((got.view(torch.int16)
                                    != chain.view(torch.int16)).sum())
                        if bits:
                            fail(f"{what}: {bits} outputs differ from "
                                 f"fused_bottleneck_chain's bits")
                        # (b) cuDNN's budget, every miss explained
                        moved, counts = rounds_apart(x, *args, **kw)
                        lone = {k: c["unexplained"]
                                for k, c in counts.items()}
                        if any(lone.values()):
                            fail(f"{what}: the plain version rounds apart "
                                 f"from the kernel without an ambiguous "
                                 f"rounding (or a value read that "
                                 f"differs) at {lone}")
                        stray = int((over & ~moved[..., None]).sum())
                        if stray:
                            fail(f"{what}: {stray} outputs exceed {atol} + "
                                 f"{rtol}*|ref| with every y2 of their "
                                 f"pixel equal to the plain version's")
                        gate["over_budget_attributed"] += int(over.sum())
                        for k, c in counts.items():
                            gate["apart"][k] = (gate["apart"].get(k, 0)
                                                + c["apart"])
                    key = (dt, f0, n)
                    worst[key] = max(worst.get(key, 0.0), err)
                    rec = dict(dtype=dt, n=n, frames=[f0, f0 + n], block=i,
                               kind=blk.kind, dilation=blk.dilation,
                               max_abs_err=err,
                               plan=plan(n, x.shape[1], x.shape[2], blk.kind,
                                         blk.dilation, x.dtype))
                    if dt == "bfloat16" and f0 == 0:
                        xi, out = x, torch.empty_like(x)
                        raw, keep = launch_args(xi, out, *args, **kw,
                                                packed=blk.packed)
                        # device time: bare launches, no Python checks
                        rec["ms"] = cuda_ms(
                            lambda: lib.bugcar_fused_bottleneck(*raw), 200)
                        rec["wrapper_ms"] = cuda_ms(lambda: blk(xi), 50)
                        rec["plain_ms"] = cuda_ms(
                            lambda: fused_bottleneck_ref(xi, *args, **kw),
                            20)
                        rec["bound_ms"], rec["bound_by"] = block_bound(
                            n, x.shape[1], x.shape[2], blk.kind, dt)
                    per_block.append(rec)
                    x = ref
            if dt == "bfloat16":
                if gate["over_budget_attributed"] > BOTTLENECK_ATTRIBUTED_CAP:
                    fail(f"fused_bottleneck bf16 frames {gate['frames']}: "
                         f"{gate['over_budget_attributed']} outputs over "
                         f"the budget, each at a flipped ambiguous "
                         f"rounding; the cap is "
                         f"{BOTTLENECK_ATTRIBUTED_CAP}")
                gates.append(gate)
                print(json.dumps({"phase": "bottleneck_gate", **gate}),
                      flush=True)
    # the 16-launch trunk chain at the main path's shape (N=1, bf16)
    fused = eng[("enet_fused", "bfloat16")]
    with torch.no_grad():
        x0 = pre.preprocess_for_config(
            torch.as_tensor(frames[0][None]).to(dev), fused.cfg)
        x0, _, _ = fused.module.encode(x0)
        x0 = x0.permute(0, 2, 3, 1).contiguous()
    blocks = fused.forward_fn.blocks
    bufs = [x0.clone(), torch.empty_like(x0)]   # ping-pong, as the path
    chain_args = [launch_args(bufs[i % 2], bufs[(i + 1) % 2], blk.wp, blk.s1,
                              blk.b1, blk.a1, blk.wcore(), blk.s2, blk.b2,
                              blk.a2, blk.we, blk.s3, blk.b3, blk.ao,
                              kind=blk.kind, dilation=blk.dilation,
                              packed=blk.packed)
                  for i, blk in enumerate(blocks)]

    def chain_kernel():
        for raw, _ in chain_args:
            lib.bugcar_fused_bottleneck(*raw)

    def chain_wrapper():
        y = x0
        for blk in blocks:
            y = blk(y)
        return y

    def chain_plain():
        y = x0
        for blk in blocks:
            y = fused_bottleneck_ref(
                y, blk.wp, blk.s1, blk.b1, blk.a1, blk.wcore(), blk.s2,
                blk.b2, blk.a2, blk.we, blk.s3, blk.b3, blk.ao,
                kind=blk.kind, dilation=blk.dilation)
        return y

    with torch.no_grad():
        trunk_ms = cuda_ms(chain_kernel, 100)
        trunk_wrapper_ms = cuda_ms(chain_wrapper, 50)
        trunk_plain_ms = cuda_ms(chain_plain, 20)
    bounds = [block_bound(1, x0.shape[1], x0.shape[2], b.kind, "bfloat16")
              for b in blocks]
    trunk_bound_ms = sum(b for b, _ in bounds)
    by_bytes = sum(b for b, by in bounds if by == "bytes")
    emit("kernels", seconds=round(time.perf_counter() - t, 3),
         tolerance={k: {"atol": v[0], "rtol": v[1]} for k, v in TOL.items()},
         max_abs_err={f"{dt}/frames={f0}-{f0 + n - 1}": e
                      for (dt, f0, n), e in worst.items()},
         bf16_gate=gates,
         trunk_16_launches_ms=trunk_ms,
         trunk_through_wrapper_ms=trunk_wrapper_ms,
         trunk_plain_ms=trunk_plain_ms,
         trunk_bound_ms=trunk_bound_ms,
         plan_main={f"{b.kind}/d={b.dilation}": plan(
             1, x0.shape[1], x0.shape[2], b.kind, b.dilation)
             for b in blocks})
    for rec in per_block:
        if rec["dtype"] == "bfloat16":
            print(json.dumps({"phase": "kernel_block", **rec}), flush=True)

    # -- path ----------------------------------------------------------------
    t = time.perf_counter()
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    cal = toy_calibration((cfg16.input_height, cfg16.input_width))
    pipe = port.Pipeline(eng[("enet_fused", "bfloat16")], cal, grid_cfg)
    plain = port.Pipeline(eng[("enet", "bfloat16")], cal, grid_cfg)
    for p in (pipe, plain):
        p.warmup(frames[0].shape)
        p.run_batch(np.stack(frames[:4]))
    torch.cuda.synchronize()

    kcuda.reset_launches()
    single = pipe(frames[0]).cpu().numpy()
    streamed = np.stack(list(pipe.stream(iter(frames), depth=2)))
    batched = pipe.run_batch(np.stack(frames[:4])).cpu().numpy()
    launches = dict(kcuda.LAUNCHES)
    # one launch per trunk block per backbone forward
    forwarded = 1 + len(frames) + 4
    batches = backbone_calls(pipe.engine, 1 + len(frames), 4)
    if launches["fused_bottleneck"] != 16 * batches:
        fail(f"fused_bottleneck launched {launches['fused_bottleneck']} "
             f"times for {batches} backbone forwards; expected "
             f"{16 * batches}")
    if sum(launches.values()) != launches["fused_bottleneck"]:
        fail(f"the ENet path launched another path's kernel: {launches}")
    want = (grid_cfg.cells_h, grid_cfg.cells_w)
    check_grids("enet", {"single": single[None], "stream": streamed,
                         "batch": batched}, want)
    same_single = float((single == streamed[0]).mean())
    same_batch = float((batched == streamed[:4]).mean())
    check_batch_invariant("enet_fused", single_vs_stream=same_single,
                          batch_vs_stream=same_batch)

    # fused vs plain engine, bf16, on the card
    plain_grids = np.stack(list(plain.stream(iter(frames), depth=2)))
    cell_agree = float((plain_grids == streamed).mean())
    with torch.no_grad():
        lab_f = pipe.engine.predict(np.stack(frames[:4])).cpu().numpy()
        lab_p = plain.engine.predict(np.stack(frames[:4])).cpu().numpy()
    label_agree = float((lab_f == lab_p).mean())
    if cell_agree < AGREE_BF16 or label_agree < AGREE_BF16:
        fail(f"enet_fused vs enet (bf16): labels {label_agree}, cells "
             f"{cell_agree} agree; budget {AGREE_BF16}")

    f32 = check_f32_card_vs_cpu(
        "enet_fused", eng[("enet_fused", "float32")],
        port.build_engine("enet", cfg32, variables=variables, device="cpu"),
        frames[0])

    speed = speed_turns((("enet_fused", pipe), ("enet", plain)), frames)
    emit("path", seconds=round(time.perf_counter() - t, 3),
         frames_forwarded=forwarded, backbone_batches=batches,
         launches=launches,
         grid_shape=list(want), single_vs_stream_cells=same_single,
         batch_vs_stream_cells=same_batch, label_agree_bf16=label_agree,
         cell_agree_bf16=cell_agree, **f32, speed=speed, nvidia_smi=smi)

    main_recs = [r for r in per_block
                 if r["dtype"] == "bfloat16" and r["n"] == 1]
    entry = {
        "name": "fused_bottleneck",
        "route": "cuda",
        "source": "bugcar_image_segmentation_tpu_torch/csrc/"
                  "fused_bottleneck.cu",
        "replaces": "bugcar_image_segmentation_tpu/ops/pallas/"
                    "bottleneck.py:146",
        "launches": launches["fused_bottleneck"],
        "max_abs_err": max(worst.values()),
        # per launch, averaged over the 16 trunk blocks at the main
        # path's shape (1x32x64x128 bf16), chained as the path runs them;
        # "ms" launches through the C launcher directly (device time),
        # the kernels phase line also has the time through the wrapper
        "ms": trunk_ms / len(blocks),
        "plain_ms": trunk_plain_ms / len(blocks),
        "bound_ms": trunk_bound_ms / len(blocks),
        "bound_by": ("bytes" if by_bytes >= trunk_bound_ms / 2
                     else "operations"),
        "library_ms": None,
    }
    assert len(main_recs) == len(blocks)
    return entry


def attention_phase(lib, clock_hz: float) -> dict:
    """Both attention kernels at the smoke's shapes against the plain
    version, bf16 and f32, timed beside the plain version and SDPA; the
    records by (kernel name, shape) and the worst error per kernel."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from bugcar_image_segmentation_tpu_torch.ops.cuda import attention as att

    t = time.perf_counter()
    records = {}
    worst = {"flash_attention": 0.0, "flash_attention_t": 0.0}
    for shape in ATTN_STAGES + ATTN_B2_STAGES + ATTN_EXTRA:
        b, h, nq, nkv, d = shape
        rng = np.random.default_rng(SEED)
        base = [torch.as_tensor(rng.standard_normal((b, h, n, d)).astype(
            np.float32), device="cuda") for n in (nq, nkv, nkv)]
        for name in ("flash_attention", "flash_attention_t"):
            fn = getattr(att, name)
            plain = (att.attention_reference_t if name == "flash_attention_t"
                     else att.attention_reference)
            rec = {"kernel": name, "shape": list(shape)}
            for dt in ("float32", "bfloat16"):
                q, k, v = (x.to(getattr(torch, dt)) for x in base)
                if name == "flash_attention_t":
                    q, k, v = (x.transpose(-1, -2).contiguous()
                               for x in (q, k, v))
                got = fn(q, k, v)
                ref = plain(q, k, v)
                torch.cuda.synchronize()
                atol, rtol = ATTN_TOL[dt]
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"{name} {shape} {dt}: output not finite")
                if bool((diff > atol + rtol * ref.float().abs()).any()):
                    fail(f"{name} {shape} {dt}: max |err| {err} exceeds "
                         f"{atol} + {rtol}*|ref|")
                worst[name] = max(worst[name], err)
                rec[f"max_abs_err_{dt}"] = err
                if dt != "bfloat16":
                    continue
                out = torch.empty_like(q)
                raw = att.launch_args(name, q, k, v, out)
                kfn = getattr(lib, f"bugcar_{name}")
                iters = max(5, min(200, int(4e9 / (b * h * nq * nkv))))
                # device time: bare launches, no Python checks
                rec["ms"] = cuda_ms(lambda: kfn(*raw), iters)
                rec["wrapper_ms"] = cuda_ms(lambda: fn(q, k, v), iters)
                rec["plain_ms"] = cuda_ms(lambda: plain(q, k, v),
                                          max(3, iters // 4))
                rec["library_ms"] = cuda_ms(
                    lambda: F.scaled_dot_product_attention(
                        q.transpose(-1, -2), k.transpose(-1, -2),
                        v.transpose(-1, -2))
                    if name == "flash_attention_t"
                    else F.scaled_dot_product_attention(q, k, v), iters)
                rec.update(attention_bound(shape, dt, clock_hz))
                rows = lib.bugcar_flash_attention_rows(
                    nq, d, 1, int(name == "flash_attention_t"))
                rec["plan"] = {"kernel": "flash_attention_mma",
                               "queries_per_cta": rows,
                               "ctas": -(-nq // rows) * b * h,
                               "threads": 2 * rows}
            records[name, shape] = rec
            print(json.dumps({"phase": "attention_case", **rec}), flush=True)
    # B2 (d = 64), the kernel of each stage's layout: token-major for the
    # one head of stage 0, channel-major for stages 1-3
    b2 = [{k: records[name, shape][k] for k in (
        "kernel", "shape", "ms", "plain_ms", "library_ms", "bound_ms",
        "bound_by", "max_abs_err_float32", "max_abs_err_bfloat16")}
          for name, shape in zip(["flash_attention"]
                                 + ["flash_attention_t"] * 3,
                                 ATTN_B2_STAGES)]
    emit("attention_kernels", seconds=round(time.perf_counter() - t, 3),
         tolerance={k: {"atol": v[0], "rtol": v[1]}
                    for k, v in ATTN_TOL.items()},
         max_abs_err=worst, sm_clock_hz=clock_hz, b2_stages=b2)
    return {"records": records, "worst": worst}


def segformer_phase(smi: str) -> dict:
    """SegFormer-B0 at 1024x1024 through Pipeline; returns the attention
    launch counts of the path's run."""
    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
        random_segformer_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    variables = random_segformer_variables(SEED)
    frames = [f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=STREAM_FRAMES, shape=FRAME_HW)]
    h, w = SEGFORMER_HW

    def engine(name, dtype="bfloat16", device="cuda"):
        cfg = port.ModelConfig(name=name, input_width=w, input_height=h,
                               dtype=dtype)
        return port.build_engine(name, cfg, variables=variables,
                                 device=device)

    eng, eng_q = engine("segformer_b0"), engine("segformer_b0_q")
    eng_plain = engine("segformer_b0")
    eng_plain.module.xla_attention = True       # the yardstick
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    cal = toy_calibration(SEGFORMER_HW)
    pipe = port.Pipeline(eng, cal, grid_cfg)
    plain = port.Pipeline(eng_plain, cal, grid_cfg)
    pipe_q = port.Pipeline(eng_q, cal, grid_cfg, interpolation="native")
    if pipe_q.builder.label_scale != 4:
        fail("segformer_b0_q's native grid does not read the quarter-res "
             "labels")
    for p in (pipe, plain, pipe_q):
        p.warmup(frames[0].shape)
        p.run_batch(np.stack(frames[:4]))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    kcuda.reset_launches()
    single = pipe(frames[0]).cpu().numpy()
    streamed = np.stack(list(pipe.stream(iter(frames), depth=2)))
    batched = pipe.run_batch(np.stack(frames[:4])).cpu().numpy()
    q_single = pipe_q(frames[0]).cpu().numpy()
    q_batched = pipe_q.run_batch(np.stack(frames[:4])).cpu().numpy()
    launches = dict(kcuda.LAUNCHES)
    # per backbone forward: 2 blocks x stage 0 (one head, token-major) and
    # 2 x stages 1-3 (several heads, channel-major)
    batches = backbone_calls(eng, 1 + len(frames) + 1, 4, 4)
    want_launches = {"flash_attention": 2 * batches,
                     "flash_attention_t": 6 * batches}
    for name, n in want_launches.items():
        if launches[name] != n:
            fail(f"{name} launched {launches[name]} times for {batches} "
                 f"backbone forwards; expected {n}")
    if launches["fused_bottleneck"] or launches["fused_sepconv"]:
        fail("the SegFormer path launched another path's kernel")
    want = (grid_cfg.cells_h, grid_cfg.cells_w)
    check_grids("segformer", {
        "single": single[None], "stream": streamed, "batch": batched,
        "q_single": q_single[None], "q_batch": q_batched}, want)
    same_single = float((single == streamed[0]).mean())
    same_batch = float((batched == streamed[:4]).mean())
    same_q = float((q_single == q_batched[0]).mean())
    check_batch_invariant("segformer_b0", single_vs_stream=same_single,
                          batch_vs_stream=same_batch,
                          q_single_vs_batch=same_q)

    # kernel vs plain attention, bf16, on the card
    plain_grids = np.stack(list(plain.stream(iter(frames), depth=2)))
    cell_agree = float((plain_grids == streamed).mean())
    with torch.no_grad():
        lab_k = eng.predict(np.stack(frames[:4])).cpu().numpy()
        lab_p = eng_plain.predict(np.stack(frames[:4])).cpu().numpy()
    label_agree = float((lab_k == lab_p).mean())
    if cell_agree < AGREE_BF16 or label_agree < AGREE_BF16:
        fail(f"segformer_b0 kernel vs plain attention (bf16): labels "
             f"{label_agree}, cells {cell_agree} agree; budget {AGREE_BF16}")

    f32 = check_f32_card_vs_cpu(
        "segformer_b0", engine("segformer_b0", "float32"),
        engine("segformer_b0", "float32", "cpu"), frames[0])

    speed = speed_turns((("segformer_b0", pipe),
                         ("segformer_b0_xla_attention", plain),
                         ("segformer_b0_q_native", pipe_q)), frames)
    emit("segformer_path", seconds=round(time.perf_counter() - t, 3),
         setup_seconds=round(setup_s, 3), input_hw=list(SEGFORMER_HW),
         backbone_batches=batches, launches=launches,
         grid_shape=list(want), single_vs_stream_cells=same_single,
         batch_vs_stream_cells=same_batch, q_single_vs_batch_cells=same_q,
         label_agree_bf16=label_agree, cell_agree_bf16=cell_agree, **f32,
         speed=speed, nvidia_smi=smi)
    return launches


def attention_entry(name: str, att: dict, launches: dict) -> dict:
    """The kernel line's entry for one attention kernel: per launch,
    averaged over the SegFormer-B0 stages where the path launches it
    (flash_attention: stage 0; flash_attention_t: stages 1-3)."""
    stages = ATTN_STAGES[:1] if name == "flash_attention" else ATTN_STAGES[1:]
    recs = [att["records"][name, s] for s in stages]

    def mean(key):
        return sum(r[key] for r in recs) / len(recs)

    bound = mean("bound_ms")
    by_bytes = sum(r["bound_ms"] for r in recs if r["bound_by"] == "bytes")
    return {
        "name": name,
        "route": "cuda",
        "source": "bugcar_image_segmentation_tpu_torch/csrc/"
                  "flash_attention.cu",
        "replaces": "bugcar_image_segmentation_tpu/ops/pallas/attention.py:"
                    + ("82" if name == "flash_attention" else "205"),
        "launches": launches[name],
        "max_abs_err": att["worst"][name],
        "ms": mean("ms"),
        "plain_ms": mean("plain_ms"),
        "bound_ms": bound,
        "bound_by": "bytes" if by_bytes >= bound * len(recs) / 2
                    else "operations",
        "library_ms": mean("library_ms"),
    }


def sepconv_bound(n: int, h: int, w: int, c: int, f: int, stride: int,
                  dtype: str):
    """(least ms, "bytes" | "operations") of one fused_sepconv launch: x
    read and the output written once, the pointwise weights (in x's
    dtype) and the f32 taps and folded BatchNorms read once; the depthwise
    and pointwise FLOPs, 2·Ho·Wo·(9C + C·F) per image, at the peak rate of
    the input type."""
    item = 2 if dtype == "bfloat16" else 4
    ho, wo = h // stride, w // stride
    flops = 2 * n * ho * wo * (9 * c + c * f)
    nbytes = (item * (n * (h * w * c + ho * wo * f) + c * f)
              + 4 * (9 * c + 2 * c + 2 * f))
    t_bytes, t_ops = nbytes / MEM_RATE, flops / PEAK[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sepconv_phase(lib) -> dict:
    """fused_sepconv at every site shape of the Xception path (N = 1 and
    4, bf16 and f32) against its plain version, timed at N = 1 in bf16;
    the records by site name and the worst error."""
    import numpy as np
    import torch

    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
    from bugcar_image_segmentation_tpu_torch.ops.cuda import sepconv as sc

    t = time.perf_counter()
    splitter = load_script("torch_sepconv_split")
    variants = splitter.build(kbuild._nvcc())   # one nvcc per variant, together
    records = {}
    worst = 0.0
    for i, (name, h, w, c, f, stride, act, per_frame) in enumerate(
            SEP_SITES):
        rng = np.random.default_rng(SEED + i)

        def dev(a):
            return torch.as_tensor(np.asarray(a, np.float32), device="cuda")

        args = [dev(rng.standard_normal((3, 3, 1, c)) * 0.3),
                dev(rng.uniform(0.7, 1.3, c)), dev(rng.uniform(-0.1, 0.1, c)),
                dev(rng.standard_normal((c, f)) / np.sqrt(c)),
                dev(rng.uniform(0.7, 1.3, f)), dev(rng.uniform(-0.1, 0.1, f))]
        base = dev(rng.standard_normal((4, h, w, c)))
        rec = {"site": name, "shape": [h, w, c, f], "stride": stride,
               "act_out": act, "launches_per_frame": per_frame}
        kw = dict(strides=stride, act_out=act)
        for dt in ("float32", "bfloat16"):
            atol, rtol = TOL[dt]
            for n in (1, 4):
                x = base[:n].to(getattr(torch, dt)).contiguous()
                got = sc.fused_sepconv(x, *args, **kw)
                ref = sc.sepconv_reference(x, *args, **kw)
                torch.cuda.synchronize()
                diff = (got.float() - ref.float()).abs()
                err = float(diff.max())
                if not bool(torch.isfinite(got.float()).all()):
                    fail(f"fused_sepconv {name} {dt} n={n}: not finite")
                if bool((diff > atol + rtol * ref.float().abs()).any()):
                    fail(f"fused_sepconv {name} {dt} n={n}: max |err| {err} "
                         f"exceeds {atol} + {rtol}*|ref|")
                worst = max(worst, err)
                rec[f"max_abs_err_{dt}_n{n}"] = err
            if dt != "bfloat16":
                continue
            x = base[:1].bfloat16().contiguous()
            out = torch.empty_like(got[:1])
            # the path passes the pointwise weights rounded once to bf16
            kargs = args[:3] + [args[3].bfloat16()] + args[4:]
            raw = sc.launch_args(x, out, *kargs, **kw)
            iters = 200 if h * w <= 64 * 128 else 50
            # device time: bare launches, no Python checks
            rec["ms"] = cuda_ms(lambda: lib.bugcar_fused_sepconv(*raw), iters)
            rec["wrapper_ms"] = cuda_ms(
                lambda: sc.fused_sepconv(x, *kargs, **kw), iters)
            rec["plain_ms"] = cuda_ms(
                lambda: sc.sepconv_reference(x, *args, **kw), iters // 4)
            rec["bound_ms"], rec["bound_by"] = sepconv_bound(
                1, h, w, c, f, stride, dt)
            rec["library_ms"] = None
            pl = sc.plan(h, w, c, f, stride)
            rec["plan"] = {"tile_rows": pl.tile_rows, "cluster": pl.cluster,
                           "stages": pl.stages}
            rec["phase_us"] = splitter.split(variants, raw)["phase_us"]
        records[name] = rec
        print(json.dumps({"phase": "sepconv_case", **rec}), flush=True)
    on_path = [r for r in records.values() if r["launches_per_frame"]]
    per_frame = {k: sum(r[k] * r["launches_per_frame"] for r in on_path)
                 for k in ("ms", "plain_ms", "bound_ms")}
    emit("sepconv_kernels", seconds=round(time.perf_counter() - t, 3),
         tolerance={k: {"atol": v[0], "rtol": v[1]} for k, v in TOL.items()},
         max_abs_err=worst, launches_per_frame=SEP_PER_FRAME,
         per_frame_bf16_n1_ms=per_frame)
    return {"records": records, "worst": worst, "per_frame": per_frame}


def xception_phase(smi: str) -> dict:
    """DeepLabV3+ / Xception-65 at 1024x512 through Pipeline, the fused
    sepconvs through the kernel; returns the launch counts of the path's
    run."""
    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_xception import \
        random_xception_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    variables = random_xception_variables(SEED)
    frames = [f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=STREAM_FRAMES, shape=FRAME_HW)]
    h, w = XCEPTION_HW

    def engine(name, dtype="bfloat16", device="cuda"):
        cfg = port.ModelConfig(name="deeplab_xception", input_width=w,
                               input_height=h, dtype=dtype)
        return port.build_engine(name, cfg, variables=variables,
                                 device=device)

    eng, eng_plain = engine("deeplab_xception_fs"), engine("deeplab_xception")
    eng_q = engine("deeplab_xception_q_fs")
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    cal = toy_calibration(XCEPTION_HW)
    pipe = port.Pipeline(eng, cal, grid_cfg)
    plain = port.Pipeline(eng_plain, cal, grid_cfg)
    pipe_q = port.Pipeline(eng_q, cal, grid_cfg, interpolation="native")
    if pipe_q.builder.label_scale != 4:
        fail("deeplab_xception_q_fs's native grid does not read the "
             "quarter-res labels")
    for p in (pipe, plain, pipe_q):
        p.warmup(frames[0].shape)
        p.run_batch(np.stack(frames[:4]))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    kcuda.reset_launches()
    single = pipe(frames[0]).cpu().numpy()
    streamed = np.stack(list(pipe.stream(iter(frames), depth=2)))
    batched = pipe.run_batch(np.stack(frames[:4])).cpu().numpy()
    q_single = pipe_q(frames[0]).cpu().numpy()
    q_streamed = np.stack(list(pipe_q.stream(iter(frames[:4]), depth=2)))
    q_batched = pipe_q.run_batch(np.stack(frames[:4])).cpu().numpy()
    launches = dict(kcuda.LAUNCHES)
    batches = (backbone_calls(eng, 1 + len(frames), 4)
               + backbone_calls(eng_q, 1 + 4, 4))
    if launches["fused_sepconv"] != SEP_PER_FRAME * batches:
        fail(f"fused_sepconv launched {launches['fused_sepconv']} times for "
             f"{batches} backbone forwards; expected "
             f"{SEP_PER_FRAME * batches}")
    if sum(launches.values()) != launches["fused_sepconv"]:
        fail(f"the Xception path launched another path's kernel: {launches}")
    kcuda.reset_launches()
    plain_grids = np.stack(list(plain.stream(iter(frames), depth=2)))
    if any(kcuda.LAUNCHES.values()):
        fail(f"the plain Xception engine launched kernels: {kcuda.LAUNCHES}")
    want = (grid_cfg.cells_h, grid_cfg.cells_w)
    check_grids("xception", {
        "single": single[None], "stream": streamed, "batch": batched,
        "plain": plain_grids, "q_single": q_single[None],
        "q_stream": q_streamed, "q_batch": q_batched}, want)
    same = {"single_vs_stream": float((single == streamed[0]).mean()),
            "batch_vs_stream": float((batched == streamed[:4]).mean()),
            "q_single_vs_batch": float((q_single == q_batched[0]).mean()),
            "q_stream_vs_batch": float((q_streamed == q_batched).mean())}
    check_batch_invariant("deeplab_xception_fs", **same)

    # kernel vs plain engine, bf16, on the card; the labels' histogram
    cell_agree = float((plain_grids == streamed).mean())
    with torch.no_grad():
        lab_k = eng.logits(np.stack(frames[:4])).argmax(-1)
        lab_p = eng_plain.logits(np.stack(frames[:4])).argmax(-1)
    label_agree = float((lab_k == lab_p).float().mean())
    share = (torch.bincount(lab_k.flatten(), minlength=eng.cfg.num_classes)
             .float() / lab_k.numel()).tolist()
    if cell_agree < AGREE_BF16 or label_agree < AGREE_BF16:
        fail(f"deeplab_xception_fs vs deeplab_xception (bf16): labels "
             f"{label_agree}, cells {cell_agree} agree; budget {AGREE_BF16}")
    if max(share) > 0.99:
        fail(f"one class takes {max(share)} of the pixels: the seeded "
             f"weights are degenerate and the agreements mean nothing")

    f32 = check_f32_card_vs_cpu(
        "deeplab_xception_fs", engine("deeplab_xception_fs", "float32"),
        engine("deeplab_xception", "float32", "cpu"), frames[0])

    speed = speed_turns((("deeplab_xception_fs", pipe),
                         ("deeplab_xception", plain),
                         ("deeplab_xception_q_fs_native", pipe_q)), frames)
    emit("xception_path", seconds=round(time.perf_counter() - t, 3),
         setup_seconds=round(setup_s, 3), input_hw=list(XCEPTION_HW),
         backbone_forwards=batches, launches=launches,
         grid_shape=list(want), batch_invariance=same,
         label_agree_bf16=label_agree, cell_agree_bf16=cell_agree,
         label_share=share, **f32, speed=speed, nvidia_smi=smi)
    return launches


def sepconv_entry(sep: dict, launches: dict) -> dict:
    """The kernel line's entry for fused_sepconv: per launch, averaged over
    the 55 launches of one frame (bf16, N = 1, site shapes weighted by
    their launches per frame)."""
    recs = [r for r in sep["records"].values() if r["launches_per_frame"]]
    per = {k: v / SEP_PER_FRAME for k, v in sep["per_frame"].items()}
    by_bytes = sum(r["bound_ms"] * r["launches_per_frame"] for r in recs
                   if r["bound_by"] == "bytes")
    return {
        "name": "fused_sepconv",
        "route": "cuda",
        "source": "bugcar_image_segmentation_tpu_torch/csrc/"
                  "fused_sepconv.cu",
        "replaces": "bugcar_image_segmentation_tpu/ops/pallas/sepconv.py:"
                    "121",
        "launches": launches["fused_sepconv"],
        "max_abs_err": sep["worst"],
        "ms": per["ms"],
        "plain_ms": per["plain_ms"],
        "bound_ms": per["bound_ms"],
        "bound_by": ("bytes" if by_bytes >= sep["per_frame"]["bound_ms"] / 2
                     else "operations"),
        "library_ms": None,
    }


def load_script(name: str):
    """``scripts/<name>.py`` as a module."""
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_busy(pipe, frames) -> dict:
    """torch.profiler over ``pipe(frame)`` for the frames, as
    ``scripts/torch_profile_path.py`` measures it (with its interval
    union): wall and device-busy ms per frame (the union of the device
    activity intervals), the busy share of the profiled wall time, device
    events per frame."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for f in frames:
            pipe(f).cpu()
        wall_us = 1e6 * (time.perf_counter() - t0)
    device = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = load_script("torch_profile_path")._busy_us(
        [(e.time_range.start, e.time_range.end) for e in device])
    n = len(frames)
    return {"profiled_wall_ms_per_frame": wall_us / n / 1e3,
            "device_busy_ms_per_frame": busy / n / 1e3,
            "device_busy_share": busy / wall_us,
            "device_events_per_frame": len(device) / n}


def bench_phase(smi: str, dev) -> dict:
    """bench.py's path on the port: enet_w16 and enet_fused_w16 with the
    host resize and the i420 transport; returns the launch counts of its
    run."""
    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.models.api import \
        frames_to_device
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    from bugcar_image_segmentation_tpu_torch.ops.host_resize import \
        resize_linear

    t = time.perf_counter()
    variables = random_enet_variables(SEED)
    frames = [f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=BENCH_STREAM_FRAMES, shape=FRAME_HW)]
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    cfg = port.ModelConfig()                  # ENet 512x256, bf16
    cal = toy_calibration((cfg.input_height, cfg.input_width))
    bench = dict(host_resize=True, transport="i420")

    def pipeline(name, dtype="bfloat16", device="cuda"):
        eng = port.build_engine(name, port.ModelConfig(name=name,
                                                       dtype=dtype),
                                variables=variables, device=device)
        return port.Pipeline(eng, cal, grid_cfg, **bench)

    names = ("enet_w16", "enet_fused_w16")
    pipes = {name: pipeline(name) for name in names}
    for p in pipes.values():
        p.warmup(frames[0].shape)
        list(p.stream(iter(frames[:8]), depth=16, sync_chunk=16,
                      transfer_batch=4))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    # -- the path's run, its launch counts and its grids ---------------------
    tail = frames[:10]          # 10 = 4 + 4 + 2: a partial last batch
    launches, grids = {}, {}
    for name, p in pipes.items():
        kcuda.reset_launches()
        single = p(frames[0]).cpu().numpy()
        batched = np.stack(list(p.stream(iter(tail), depth=16,
                                         sync_chunk=16, transfer_batch=4)))
        launches[name] = dict(kcuda.LAUNCHES)
        per_frame = np.stack([p(f).cpu().numpy() for f in tail])
        grids[name] = per_frame
        check_grids(f"bench_path {name}", {"single": single[None],
                                           "transfer_batch_4": batched,
                                           "per_frame": per_frame},
                    (grid_cfg.cells_h, grid_cfg.cells_w))
        check_batch_invariant(
            f"bench_path {name}",
            single_vs_per_frame=float((single == per_frame[0]).mean()),
            transfer_batch_4_vs_per_frame=float((batched
                                                 == per_frame).mean()))
    # one single frame and three 4-frame transfer batches: 4 forwards
    want_fused = 16 * 4
    got = launches["enet_fused_w16"]
    if (got["fused_bottleneck"] != want_fused
            or sum(got.values()) != want_fused):
        fail(f"bench_path enet_fused_w16 launched {got}; expected "
             f"{want_fused} fused_bottleneck launches and nothing else")
    if any(launches["enet_w16"].values()):
        fail(f"bench_path enet_w16 launched kernels: {launches['enet_w16']}")

    # -- fused vs plain trunk (bf16), card vs CPU (f32) -----------------------
    seg = {name: np.stack([p.segment_and_grid(f)[1].cpu().numpy()
                           for f in frames[:4]]) for name, p in pipes.items()}
    label_agree = float((seg["enet_w16"] == seg["enet_fused_w16"]).mean())
    cell_agree = float((grids["enet_w16"] == grids["enet_fused_w16"]).mean())
    if label_agree < AGREE_BF16 or cell_agree < AGREE_BF16:
        fail(f"bench_path enet_fused_w16 vs enet_w16 (bf16): labels "
             f"{label_agree}, cells {cell_agree} agree; budget {AGREE_BF16}")
    card32, cpu32 = (pipeline("enet_w16", "float32", d)
                     for d in ("cuda", "cpu"))
    f32_labels = float(np.mean([
        (card32.segment_and_grid(f)[1].cpu().numpy()
         == cpu32.segment_and_grid(f)[1].numpy()).mean()
        for f in frames[:2]]))
    if f32_labels < AGREE_F32:
        fail(f"bench_path enet_w16 f32 labels on the card vs the CPU agree "
             f"on {f32_labels}; budget {AGREE_F32}")
    f32 = check_f32_card_vs_cpu(
        "bench_path enet_w16", card32.engine, cpu32.engine,
        resize_linear(frames[0], (cfg.input_height, cfg.input_width)))
    del card32, cpu32

    # -- speed ----------------------------------------------------------------
    def latency_ms(p):
        out = []
        for i in range(BENCH_LATENCY_FRAMES):
            s = time.perf_counter()
            p(frames[i]).cpu()
            out.append(1e3 * (time.perf_counter() - s))
        return float(np.percentile(out, 50))

    def stream_fps(p, k):
        s = time.perf_counter()
        n = sum(1 for _ in p.stream(iter(frames), depth=16, sync_chunk=16,
                                    transfer_batch=k))
        return n / (time.perf_counter() - s)

    runs = [(name, k) for name in names for k in (4, 1)]
    for name, k in runs:                       # the warm pass
        stream_fps(pipes[name], k)
    fps = {run: [] for run in runs}
    for r in range(BENCH_PASSES):
        for run in (runs if r % 2 == 0 else runs[::-1]):
            fps[run].append(stream_fps(pipes[run[0]], run[1]))
    speed = {}
    for name, p in pipes.items():
        prep = []
        for f in frames[:BENCH_LATENCY_FRAMES]:
            s = time.perf_counter()
            packed = p._prep_host(f)
            prep.append(1e3 * (time.perf_counter() - s))
        h2d, d2h = [], []
        for _ in range(BENCH_LATENCY_FRAMES):
            torch.cuda.synchronize()
            s = time.perf_counter()
            x = frames_to_device(packed[None], dev)
            torch.cuda.synchronize()
            h2d.append(1e3 * (time.perf_counter() - s))
            g = p._program(x)[0]
            torch.cuda.synchronize()
            s = time.perf_counter()
            g.cpu()
            d2h.append(1e3 * (time.perf_counter() - s))
        speed[name] = {
            "latency_p50_ms": latency_ms(p),
            "fps_transfer_batch_4": {"median": float(np.median(
                fps[(name, 4)])), "passes": fps[(name, 4)]},
            "fps_transfer_batch_1": {"median": float(np.median(
                fps[(name, 1)])), "passes": fps[(name, 1)]},
            "host_prep_ms_p50": float(np.percentile(prep, 50)),
            "h2d_copy_ms_p50": float(np.percentile(h2d, 50)),
            "d2h_copy_ms_p50": float(np.percentile(d2h, 50)),
            "packed_bytes": int(packed.nbytes),
            **device_busy(p, frames[:PROFILE_FRAMES]),
        }
    emit("bench_path", seconds=round(time.perf_counter() - t, 3),
         setup_seconds=round(setup_s, 3), camera_hw=list(FRAME_HW),
         model_hw=[cfg.input_height, cfg.input_width], launches=launches,
         label_agree_bf16=label_agree, cell_agree_bf16=cell_agree,
         f32_card_vs_cpu_labels_i420=f32_labels, **f32, speed=speed,
         nvidia_smi=smi)
    return launches["enet_fused_w16"]


def probe_phase(lib, dev) -> list:
    """The probe script's run through the two kernels, then each kernel at
    the probes' shapes against its plain version, timed; returns the
    kernel line's three entries."""
    import torch

    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    from bugcar_image_segmentation_tpu_torch.ops.cuda import probes

    t = time.perf_counter()
    script = load_script("torch_probe_strided")
    x32 = script.probe_input(dev)
    script.run_probes(dev)                       # builds nothing new; warm
    torch.cuda.synchronize()
    kcuda.reset_launches()
    results = script.run_probes(dev)
    torch.cuda.synchronize()
    launches = dict(kcuda.LAUNCHES)
    wrong = [name for name, ok in results if not ok]
    if wrong:
        fail(f"torch_probe_strided: WRONG RESULT for {wrong}")
    extra = {k: v for k, v in launches.items() if k not in PROBE_LAUNCHES}
    if ({k: launches[k] for k in PROBE_LAUNCHES} != PROBE_LAUNCHES
            or any(extra.values())):
        fail(f"the probe run launched {launches}; expected {PROBE_LAUNCHES}")

    # (kernel, dtype, strides or None for the halo, launches per run)
    cases = [("strided_gather", torch.float32, (2, 1), 2),
             ("strided_gather", torch.float32, (1, 2), 2),
             ("strided_gather_bf16", torch.bfloat16, (2, 1), 1),
             ("strided_gather_bf16", torch.bfloat16, (1, 2), 2),
             ("strided_gather_bf16", torch.bfloat16, (2, 2), 1),
             ("halo_add", torch.float32, None, 1)]
    recs = []
    for name, dtype, strides, per_run in cases:
        x = x32.to(dtype)
        if strides is None:
            got, ref = probes.halo_add(x), probes.halo_add_reference(x)
            out = torch.empty_like(x)
            raw = probes.halo_args(x, out)
            bare = lib.bugcar_halo_add

            def library(x=x):
                xp = torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1))
                return xp[:x.shape[0], :x.shape[1]] + xp[2:, 2:]
            wrapper = (lambda x=x: probes.halo_add(x))
            plain = (lambda x=x: probes.halo_add_reference(x))
            nbytes = 2 * x.numel() * x.element_size()
        else:
            sr, sw = strides
            got = probes.strided_gather(x, sr, sw)
            ref = probes.strided_gather_reference(x, sr, sw)
            out = torch.empty_like(ref)
            raw = probes.gather_args(x, out, sr, sw)
            bare = lib.bugcar_strided_gather
            library = (lambda x=x, sr=sr, sw=sw: x[::sr, ::sw].contiguous())
            wrapper = (lambda x=x, sr=sr, sw=sw:
                       probes.strided_gather(x, sr, sw))
            plain = (lambda x=x, sr=sr, sw=sw:
                     probes.strided_gather_reference(x, sr, sw))
            # the selected elements read once, the output written once
            nbytes = 2 * ref.numel() * ref.element_size()
        torch.cuda.synchronize()
        if not torch.equal(got, ref):
            fail(f"{name} {strides} {dtype}: the kernel differs from its "
                 f"plain version")
        rec = {"kernel": name, "dtype": str(dtype).split(".")[-1],
               "strides": list(strides) if strides else None,
               "shape": list(x.shape), "launches_per_run": per_run,
               "max_abs_err": float((got.float() - ref.float()).abs().max()),
               # device time: bare launches, no Python checks
               "ms": cuda_ms(lambda raw=raw, bare=bare: bare(*raw), 1000),
               "wrapper_ms": cuda_ms(wrapper, 500),
               "plain_ms": cuda_ms(plain, 500),
               "library_ms": cuda_ms(library, 500),
               "bound_ms": 1e3 * nbytes / MEM_RATE, "bound_by": "bytes"}
        recs.append(rec)
        print(json.dumps({"phase": "probe_case", **rec}), flush=True)
    emit("probe_kernels", seconds=round(time.perf_counter() - t, 3),
         probes={name: ok for name, ok in results}, launches=launches)

    replaces = {"strided_gather": "scripts/probe_mosaic.py:30",
                "strided_gather_bf16": "scripts/probe_mosaic.py:81",
                "halo_add": "scripts/probe_mosaic.py:111"}
    entries = []
    for name, line in replaces.items():
        mine = [r for r in recs if r["kernel"] == name]
        runs = sum(r["launches_per_run"] for r in mine)

        def mean(key, mine=mine, runs=runs):
            # per launch, weighted as the probe run launches each shape
            return sum(r[key] * r["launches_per_run"] for r in mine) / runs
        entries.append({
            "name": name, "route": "cuda",
            "source": "bugcar_image_segmentation_tpu_torch/csrc/"
                      "strided_probes.cu",
            "replaces": line, "launches": launches[name],
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": mean("ms"), "plain_ms": mean("plain_ms"),
            "bound_ms": mean("bound_ms"), "bound_by": "bytes",
            "library_ms": mean("library_ms")})
    return entries


def model_path_phase(phase: str, smi: str, names, hw, random_variables,
                     quarter=()) -> dict:
    """A backbone the port runs without a kernel of its own (the
    MobileNetV2 DeepLab, UNet), at full width, bf16, seeded weights,
    through Pipeline (``quarter``: those engines on the native grid);
    returns the phase line's fields."""
    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    variables = random_variables(SEED)
    frames = [f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=STREAM_FRAMES, shape=FRAME_HW)]
    h, w = hw

    def engine(name, dtype="bfloat16", device="cuda"):
        cfg = port.ModelConfig(name=name, input_width=w, input_height=h,
                               dtype=dtype)
        return port.build_engine(name, cfg, variables=variables,
                                 device=device)

    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    cal = toy_calibration(hw)
    pipes = {}
    for name in names:
        interp = "native" if name in quarter else "cv2_linear"
        pipes[name] = port.Pipeline(engine(name), cal, grid_cfg,
                                    interpolation=interp)
        if name in quarter and pipes[name].builder.label_scale != 4:
            fail(f"{name}'s native grid does not read the quarter-res "
                 f"labels")
    for p in pipes.values():
        p.warmup(frames[0].shape)
        p.run_batch(np.stack(frames[:4]))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    want = (grid_cfg.cells_h, grid_cfg.cells_w)
    out = {}
    for name, p in pipes.items():
        kcuda.reset_launches()
        single = p(frames[0]).cpu().numpy()
        streamed = np.stack(list(p.stream(iter(frames), depth=2)))
        batched = p.run_batch(np.stack(frames[:4])).cpu().numpy()
        if any(kcuda.LAUNCHES.values()):
            fail(f"{name} launched kernels: {kcuda.LAUNCHES}")
        check_grids(name, {"single": single[None], "stream": streamed,
                           "batch": batched}, want)
        same = {"single_vs_stream": float((single == streamed[0]).mean()),
                "batch_vs_stream": float((batched == streamed[:4]).mean())}
        check_batch_invariant(name, **same)
        with torch.no_grad():
            lab = p.engine.logits(np.stack(frames[:4])).argmax(-1)
        share = (torch.bincount(lab.flatten(), minlength=p.engine.cfg
                                .num_classes).float() / lab.numel()).tolist()
        if max(share) > 0.99:
            fail(f"{name}: one class takes {max(share)} of the pixels: the "
                 f"seeded weights are degenerate")
        out[name] = {"batch_invariance": same, "label_share": share,
                     **check_f32_card_vs_cpu(name, engine(name, "float32"),
                                             engine(name, "float32", "cpu"),
                                             frames[0]),
                     **device_busy(p, frames[:PROFILE_FRAMES])}
    speed = speed_turns(list(pipes.items()), frames)
    emit(phase, seconds=round(time.perf_counter() - t, 3),
         setup_seconds=round(setup_s, 3), input_hw=list(hw),
         grid_shape=list(want), engines=out, speed=speed, nvidia_smi=smi)
    return out


def rig_phase(smi: str) -> dict:
    """The 4-camera rig (MultiCameraPipeline) on ENet at 512x256, bf16
    weights, the kernel engine (the bottleneck at N = 4) against the plain
    one, with cv2_linear and native grids; returns the launch counts of
    its run."""
    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    variables = random_enet_variables(SEED)
    frames = [f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=STREAM_FRAMES, shape=FRAME_HW)]
    ncam = len(RIG_YAWS)
    rig_frames = [np.stack(frames[i:i + ncam])
                  for i in range(0, len(frames), ncam)]
    hw = (256, 512)
    cals = [toy_calibration(hw, yaw=y) for y in RIG_YAWS]
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)

    def engine(name, dtype="bfloat16", device="cuda"):
        return port.build_engine(name, port.ModelConfig(name=name,
                                                        dtype=dtype),
                                 variables=variables, device=device)

    names = ("enet_fused_w16", "enet_w16")
    engines = {name: engine(name) for name in names}
    rigs, cams = {}, {}
    for name, eng in engines.items():
        for interp in RIG_GRIDS:
            rigs[name, interp] = port.MultiCameraPipeline(
                eng, cals, grid_cfg, interpolation=interp)
            cams[name, interp] = [port.Pipeline(eng, c, grid_cfg,
                                                interpolation=interp)
                                  for c in cals]
    for key, rig in rigs.items():
        rig(rig_frames[0]).cpu()
        for i, p in enumerate(cams[key]):
            p(rig_frames[0][i]).cpu()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    stitched, launches = {}, {}
    for name in names:
        kcuda.reset_launches()
        for interp in RIG_GRIDS:
            stitched[name, interp] = np.stack(
                [rigs[name, interp](f).cpu().numpy() for f in rig_frames])
        launches[name] = dict(kcuda.LAUNCHES)
    fused = launches["enet_fused_w16"]
    want_fused = 16 * len(RIG_GRIDS) * len(rig_frames)   # one batch a frame
    if fused["fused_bottleneck"] != want_fused or sum(fused.values()) \
            != want_fused:
        fail(f"the rig's enet_fused_w16 launched {fused}; expected "
             f"{want_fused} fused_bottleneck launches and nothing else")
    if any(launches["enet_w16"].values()):
        fail(f"the rig's enet_w16 launched kernels: {launches['enet_w16']}")
    want = (grid_cfg.cells_h, grid_cfg.cells_w)
    same = {}
    for key, grids in stitched.items():
        check_grids(f"rig {key}", {"stitched": grids}, want)
        per_cam = np.stack([np.stack([p(f[i]).cpu().numpy()
                                      for i, p in enumerate(cams[key])])
                            for f in rig_frames])
        same["/".join(key)] = float((grids == per_cam.max(1)).mean())
    check_batch_invariant("rig: stitched vs the max of the per-camera "
                          "Pipeline grids", **same)
    agree = {interp: float((stitched["enet_fused_w16", interp]
                            == stitched["enet_w16", interp]).mean())
             for interp in RIG_GRIDS}
    if min(agree.values()) < AGREE_BF16:
        fail(f"the rig's enet_fused_w16 vs enet_w16 (bf16): stitched cells "
             f"agree {agree}; budget {AGREE_BF16}")
    f32 = check_f32_card_vs_cpu(
        "rig enet_fused_w16", engine("enet_fused_w16", "float32"),
        engine("enet_w16", "float32", "cpu"),
        synthetic.road_scene(np.random.default_rng(SEED), hw)[0])

    def rig_ms(rig, r):
        s = time.perf_counter()
        rig(rig_frames[r % len(rig_frames)]).cpu()
        return 1e3 * (time.perf_counter() - s)

    def camera_ms(p, r):
        s = time.perf_counter()
        p(frames[r % len(frames)]).cpu()
        return 1e3 * (time.perf_counter() - s)

    runs = list(rigs)
    samples = {key: {"rig_ms": [], "one_camera_ms": []} for key in runs}
    for r in range(SPEED_ROUNDS * 2):
        for key in (runs if r % 2 == 0 else runs[::-1]):
            samples[key]["rig_ms"].append(rig_ms(rigs[key], r))
            samples[key]["one_camera_ms"].append(camera_ms(cams[key][0], r))
    speed = {}
    for key, got in samples.items():
        busy = device_busy(rigs[key], rig_frames)
        speed["/".join(key)] = {
            **{m: quartiles(v) for m, v in got.items()},
            "rig_fps": 1e3 / quartiles(got["rig_ms"])["median"],
            **{f"rig_{k}": v for k, v in busy.items()}}
    emit("rig_path", seconds=round(time.perf_counter() - t, 3),
         setup_seconds=round(setup_s, 3), cameras=ncam,
         yaws=list(RIG_YAWS), input_hw=list(hw), rig_frames=len(rig_frames),
         launches=launches, stitched_vs_per_camera_max=same,
         cell_agree_bf16=agree, **f32, speed=speed, nvidia_smi=smi)
    return fused


def grid_options_phase(smi: str) -> dict:
    """Laserscan grids (multiclass and binary), CLAHE and the contour
    filter on ENet's kernel engine (bf16, 512x256) through Pipeline;
    returns the launch counts of its run."""
    import dataclasses

    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    variables = random_enet_variables(SEED)
    frames = [f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=STREAM_FRAMES, shape=FRAME_HW)]
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    cal = toy_calibration((256, 512))
    scan = dataclasses.replace(cal, laserscan=True)
    options = {"laserscan_multiclass": (scan, {}),
               "laserscan_binary": (scan, {"mode": "binary"}),
               "clahe": (cal, {"use_clahe": True}),
               "contour_filter": (cal, {"contour_filter": True})}

    def pipeline(option, dtype="bfloat16", device="cuda"):
        name = "enet_fused" if device == "cuda" else "enet"
        eng = port.build_engine(name, port.ModelConfig(name=name,
                                                       dtype=dtype),
                                variables=variables, device=device)
        c, kw = options[option]
        return port.Pipeline(eng, c, grid_cfg, **kw)

    pipes = {option: pipeline(option) for option in options}
    for p in pipes.values():
        p.warmup(frames[0].shape)
        p.run_batch(np.stack(frames[:4]))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    cells = (grid_cfg.cells_h, grid_cfg.cells_w)
    kcuda.reset_launches()
    out = {}
    for option, p in pipes.items():
        single = p(frames[0]).cpu().numpy()
        streamed = np.stack(list(p.stream(iter(frames), depth=2)))
        batched = p.run_batch(np.stack(frames[:4])).cpu().numpy()
        want = (2,) + cells if option == "laserscan_binary" else cells
        check_grids(option, {"single": single[None], "stream": streamed,
                             "batch": batched}, want)
        same = {"single_vs_stream": float((single == streamed[0]).mean()),
                "batch_vs_stream": float((batched == streamed[:4]).mean())}
        check_batch_invariant(option, **same)
        out[option] = {"batch_invariance": same, "grid_shape": list(want),
                       "cell_values": {str(v): int(n) for v, n in zip(
                           *np.unique(streamed, return_counts=True))}}
    launches = dict(kcuda.LAUNCHES)
    forwards = len(options) * (1 + len(frames) + 1)
    if launches["fused_bottleneck"] != 16 * forwards or \
            sum(launches.values()) != launches["fused_bottleneck"]:
        fail(f"grid_options launched {launches}; expected "
             f"{16 * forwards} fused_bottleneck launches and nothing else")
    for option in options:
        card, cpu = pipeline(option, "float32"), pipeline(option, "float32",
                                                          "cpu")
        got = np.stack([card(f).cpu().numpy() for f in frames[:2]])
        ref = np.stack([cpu(f).numpy() for f in frames[:2]])
        agree = float((got == ref).mean())
        if agree < AGREE_F32:
            fail(f"{option} f32 grids on the card vs the CPU agree on "
                 f"{agree}; budget {AGREE_F32}")
        out[option]["f32_card_vs_cpu_cells"] = agree
        if option == "clahe":
            from bugcar_image_segmentation_tpu_torch.postproc import clahe
            enhanced = clahe(torch.as_tensor(frames[0])).numpy()
            out[option].update(check_f32_card_vs_cpu(
                "clahe", card.engine, cpu.engine, enhanced))
        out[option].update(device_busy(pipes[option],
                                       frames[:PROFILE_FRAMES]))
    speed = speed_turns(list(pipes.items()), frames)
    emit("grid_options", seconds=round(time.perf_counter() - t, 3),
         setup_seconds=round(setup_s, 3), options=out, launches=launches,
         speed=speed, nvidia_smi=smi)
    return launches


def int8_sites(engine, frame) -> list:
    """The operands of every int8 product of one frame's forward, in call
    order."""
    import torch
    seen = []

    def watch(mm, a, b):
        seen.append((a, b))
        return mm(a, b)

    with int8_mm_as(watch), torch.no_grad():
        engine.logits(frame)
    return seen


def int8_site_records(name: str, sites: list) -> list:
    """At each (M, K, N) of ``sites``: ``torch._int_mm`` (through
    ``int8_mm``) equal to the exact product of the same int8 operands (an
    f64 GEMM: every partial sum is an integer below 127^2 * K < 2^53), and
    its device µs beside the whole int8 path (quantize, product, rescale)
    and a bf16 ``F.linear`` of the same shape."""
    import torch
    import torch.nn.functional as F

    from bugcar_image_segmentation_tpu_torch.ops import quant
    by_shape = {}
    for a, b in sites:
        key = (a.shape[0], a.shape[1], b.shape[1])
        by_shape.setdefault(key, [a, b, 0])[2] += 1
    out = []
    for (m, k, n), (a, b, count) in by_shape.items():
        got = quant.int8_mm(a, b)
        exact = (a.double() @ b.double()).long()
        if not torch.equal(got.long(), exact):
            fail(f"{name}: torch._int_mm at (M, K, N) = {(m, k, n)} differs "
                 f"from the exact product at "
                 f"{int((got.long() != exact).sum())} elements")
        gen = torch.Generator(device="cuda").manual_seed(SEED)
        x = torch.randn((m, k), device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        w = torch.randn((n, k), device="cuda", generator=gen,
                        dtype=torch.bfloat16)
        w_q, w_s = quant.quantize_weight_int8(w.float().t())
        iters = max(20, min(500, int(2e10 / (m * k * n))))
        rec = {"engine": name, "m": m, "k": k, "n": n,
               "sites_per_frame": count, "equal_to_exact": True,
               "int_mm_us": 1e3 * cuda_ms(lambda: quant.int8_mm(a, b),
                                          iters),
               "int8_path_us": 1e3 * cuda_ms(
                   lambda: quant.int8_linear(x, w_q, w_s), iters),
               "bf16_linear_us": 1e3 * cuda_ms(lambda: F.linear(x, w),
                                               iters)}
        print(json.dumps({"phase": "int8_site", **rec}), flush=True)
        out.append(rec)
    return out


def variants_phase(smi: str) -> dict:
    """The variants of the serving surface (``VARIANTS``) at full width,
    bf16, seeded, through Pipeline; returns the kernels' launch counts of
    their runs."""
    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
        random_segformer_variables
    from bugcar_image_segmentation_tpu_torch.convert.flax_xception import \
        random_xception_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    trees = {"b0": random_segformer_variables(SEED),
             "b2": random_segformer_variables(SEED, "b2"),
             "xception": random_xception_variables(SEED)}
    frames = [f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=STREAM_FRAMES, shape=FRAME_HW)]

    def engine(name, hw, dtype="bfloat16", device="cuda"):
        family = ("xception" if "xception" in name
                  else "b2" if "_b2" in name else "b0")
        cfg = port.ModelConfig(
            name="deeplab_xception" if family == "xception" else name,
            input_width=hw[1], input_height=hw[0], dtype=dtype)
        return port.build_engine(name, cfg, variables=trees[family],
                                 device=device)

    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    pipes = {}
    for name, _, hw, interp in VARIANTS:
        p = port.Pipeline(engine(name, hw), toy_calibration(hw), grid_cfg,
                          interpolation=interp)
        if interp == "native" and p.builder.label_scale != 4:
            fail(f"{name}'s native grid does not read the quarter-res "
                 f"labels")
        p.warmup(frames[0].shape)
        p.run_batch(np.stack(frames[:4]))
        pipes[name] = p
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t

    want = (grid_cfg.cells_h, grid_cfg.cells_w)
    total = dict.fromkeys(kcuda.LAUNCHES, 0)
    out = {}
    for name, twin, hw, _ in VARIANTS:
        p = pipes[name]
        eng = p.engine
        kcuda.reset_launches()
        single = p(frames[0]).cpu().numpy()
        streamed = np.stack(list(p.stream(iter(frames), depth=2)))
        batched = p.run_batch(np.stack(frames[:4])).cpu().numpy()
        launches = dict(kcuda.LAUNCHES)
        forwards = backbone_calls(eng, 1 + len(frames), 4)
        expect = dict.fromkeys(launches, 0)
        if eng.family == "segformer":
            depths = eng.module.depths
            expect["flash_attention"] = depths[0] * forwards
            expect["flash_attention_t"] = sum(depths[1:]) * forwards
        if launches != expect:
            fail(f"{name} launched {launches} for {forwards} backbone "
                 f"forwards; expected {expect}")
        for k, v in launches.items():
            total[k] += v
        check_grids(name, {"single": single[None], "stream": streamed,
                           "batch": batched}, want)
        same = {"single_vs_stream": float((single == streamed[0]).mean()),
                "batch_vs_stream": float((batched == streamed[:4]).mean())}
        check_batch_invariant(name, **same)

        # the flag's effect in bf16, a record (seeded weights: near-ties)
        with torch.no_grad():
            lab = eng.logits(np.stack(frames[:4])).argmax(-1)
            lab_twin = engine(twin, hw).logits(
                np.stack(frames[:4])).argmax(-1)
        share = (torch.bincount(lab.flatten(), minlength=eng.cfg.num_classes)
                 .float() / lab.numel()).tolist()
        rec = {"forwards": forwards, "launches": launches,
               "batch_invariance": same,
               f"label_agree_bf16_vs_{twin}":
                   float((lab == lab_twin).float().mean()),
               "label_share": share}
        if eng.int8:
            sites = int8_sites(eng, frames[0])
            rec["int8_sites_per_frame"] = len(sites)
            rec["int8_sites"] = int8_site_records(name, sites)
            if not sites:
                fail(f"{name} ran no int8 product")
        rec.update(check_f32_card_vs_cpu(
            name, engine(name, hw, "float32"),
            engine(name, hw, "float32", "cpu"), frames[0], int8=eng.int8))
        rec.update(device_busy(p, frames[:PROFILE_FRAMES]))
        out[name] = rec
    speed = speed_turns(list(pipes.items()), frames)
    emit("variants_path", seconds=round(time.perf_counter() - t, 3),
         setup_seconds=round(setup_s, 3), grid_shape=list(want),
         engines=out, launches=total, speed=speed, nvidia_smi=smi)
    return total


def fusion_phase(smi: str) -> dict:
    """``segment_frame`` on ``enet_fused_w16`` over synthetic frames with
    odometry, fused by ``TemporalGridFusion`` on the card and on the host
    (ms an update: host clock, the torch backend's fused grid fetched to
    the host); returns the kernels' launch counts of the segment_frame
    run."""
    import numpy as np
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda

    t = time.perf_counter()
    eng = port.build_engine("enet_fused_w16", port.ModelConfig(),
                            variables=random_enet_variables(SEED))
    hw = (eng.cfg.input_height, eng.cfg.input_width)
    cal = toy_calibration(hw)
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    video = list(synthetic.video(seed=SEED, num_frames=FUSION_FRAMES,
                                 shape=FRAME_HW))
    motion = [odo[:2] for _, _, odo in video]
    port.segment_frame(video[0][0], eng, cal, grid_cfg).cpu()
    torch.cuda.synchronize()

    kcuda.reset_launches()
    s = time.perf_counter()
    grids = [port.segment_frame(f, eng, cal, grid_cfg) for f, _, _ in video]
    torch.cuda.synchronize()
    segment_ms = 1e3 * (time.perf_counter() - s) / len(video)
    launches = dict(kcuda.LAUNCHES)
    if (launches["fused_bottleneck"] != 16 * len(video)
            or sum(launches.values()) != launches["fused_bottleneck"]):
        fail(f"segment_frame on enet_fused_w16 launched {launches} for "
             f"{len(video)} frames; expected 16 fused_bottleneck each")
    host_grids = [g.cpu().numpy() for g in grids]
    check_grids("segment_frame", {"grids": np.stack(host_grids)},
                (grid_cfg.cells_h, grid_cfg.cells_w))

    shape = (grid_cfg.cells_h, grid_cfg.cells_w)
    card = port.TemporalGridFusion(shape, backend="torch",
                                   cell_m=grid_cfg.cell_m)
    host = port.TemporalGridFusion(shape, cell_m=grid_cfg.cell_m)
    for g, hg, m in zip(grids, host_grids, motion):
        a = card.update(g, motion_m=m).cpu().numpy()
        b = host.update(hg, motion_m=m)
        if not np.array_equal(a, b):
            fail(f"fused grids of the torch (cuda) and numpy backends "
                 f"differ at {int((a != b).sum())} cells")
    if not np.array_equal(card.state.odds.cpu().numpy(), host._odds):
        fail("the torch (cuda) and numpy backends' odds differ")
    if not {0, 100} <= set(np.unique(b).tolist()):
        fail(f"the fused grid holds {np.unique(b)}: no free and occupied "
             f"cells both")

    def update_ms(fusion, gs, fetch):
        ms = []
        for _ in range(FUSION_PASSES):
            fusion.reset()
            for g, m in zip(gs, motion):
                s = time.perf_counter()
                fetch(fusion.update(g, motion_m=m))
                ms.append(1e3 * (time.perf_counter() - s))
        return quartiles(ms)

    emit("fusion_path", seconds=round(time.perf_counter() - t, 3),
         frames=len(video), launches=launches,
         segment_frame_ms=segment_ms, fused_equal=True, odds_equal=True,
         fused_values=sorted(np.unique(b).tolist()),
         motion_cells_total=[float(sum(m[0] for m in motion)
                                   / grid_cfg.cell_m),
                             float(sum(m[1] for m in motion)
                                   / grid_cfg.cell_m)],
         update_ms={"torch_cuda": update_ms(card, grids,
                                            lambda r: r.cpu()),
                    "numpy": update_ms(host, host_grids, lambda r: r)},
         nvidia_smi=smi)
    return launches


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU host",
              file=sys.stderr)
        return 2
    try:
        import bugcar_image_segmentation_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port package is not importable ({exc}); "
              f"run from the root of a checkout", file=sys.stderr)
        return 2
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild

    # float32 on the card means float32: cuDNN convs default to TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- env -----------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0])
    dev = torch.device("cuda")
    emit("env", nvidia_smi=smi, sm_clock_max_mhz=clock_mhz,
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), cudnn_allow_tf32=False,
         float32_matmul_precision="highest")

    # -- build ---------------------------------------------------------------
    t = time.perf_counter()
    lib = kbuild.library()
    ptxas = [ln.strip() for ln in kbuild.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t, 3),
         nvcc_seconds=kbuild.build_seconds, ptxas=ptxas)

    enet_entry = enet_phases(lib, smi, dev)
    bench_launches = bench_phase(smi, dev)
    # fused_bottleneck runs on two paths: ENet's ("path") and bench.py's
    enet_entry["launches"] += bench_launches["fused_bottleneck"]
    att = attention_phase(lib, 1e6 * clock_mhz)
    seg_launches = segformer_phase(smi)
    sep = sepconv_phase(lib)
    xc_launches = xception_phase(smi)
    from bugcar_image_segmentation_tpu_torch.convert.flax_deeplab import \
        random_deeplab_variables
    from bugcar_image_segmentation_tpu_torch.convert.flax_unet import \
        random_unet_variables
    model_path_phase("deeplab_path", smi, ("deeplab", "deeplab_q"),
                     DEEPLAB_HW, random_deeplab_variables,
                     quarter=("deeplab_q",))
    model_path_phase("unet_path", smi, ("unet",), UNET_HW,
                     random_unet_variables)
    # the rig, the grid options and the fusion path run the bottleneck too
    for launches in (rig_phase(smi), grid_options_phase(smi)):
        enet_entry["launches"] += launches["fused_bottleneck"]
    probe_entries = probe_phase(lib, dev)
    # the variants path runs both attention kernels
    for name, n in variants_phase(smi).items():
        seg_launches[name] += n
    enet_entry["launches"] += fusion_phase(smi)["fused_bottleneck"]

    # -- result --------------------------------------------------------------
    kernels = ([enet_entry] + [attention_entry(n, att, seg_launches)
                               for n in ("flash_attention",
                                         "flash_attention_t")]
               + [sepconv_entry(sep, xc_launches)] + probe_entries)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
