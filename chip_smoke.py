#!/usr/bin/env python3
"""Smoke run of the PyTorch port's main path on one NVIDIA GPU.

    python3 chip_smoke.py

from the root of a checkout, on a host with one CUDA card, nvcc and
nvidia-smi.  It imports only ``bugcar_image_segmentation_tpu_torch`` (no
JAX, no Flax, no cv2, no msgpack) and runs, printing one JSON line per
phase with its elapsed seconds:

1. ``env``    — the card, its power limit (nvidia-smi), torch / CUDA versions.
2. ``build``  — nvcc builds ``csrc/*.cu`` into ``build/kernels/``.
3. ``kernels``— ``fused_bottleneck`` on every trunk block (all kinds and
   dilations) at the main path's shape (N = 1 and 4, 32x64x128, mid 32),
   on the real trunk activations of a seeded ENet, held against its plain
   PyTorch version in bfloat16 and in float32 (TF32 off), and timed with
   CUDA events.
4. ``path``   — ``build_engine("enet_fused")`` with seeded weights (a
   Flax-layout numpy tree through the weight bridge) and ``Pipeline`` at
   ENet's full width (512x256, 15 classes) on synthetic 640x480 frames:
   ``pipe(frame)``, ``pipe.stream(frames, depth=2)`` and a 4-frame batch,
   with the kernel's launch count read around exactly that run; grids
   checked for shape, dtype and values, and held against the plain
   ``"enet"`` engine on the card and a float32 CPU run of the port.

Then it prints the nvidia-smi name/power-limit line, a ``{"kernels": ...}``
line, and last ``{"ok": true, "device": {...}}``.  Any failed check exits
non-zero before those lines; a hang turns into a traceback and a non-zero
exit (faulthandler).
"""

from __future__ import annotations

import faulthandler
import json
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
# kernel vs plain version, |got - ref| <= atol + rtol * |ref|:
TOL = {"float32": (2e-4, 2e-4),      # the JAX package's f32 budget
       "bfloat16": (2 ** -6, 2 ** -5)}  # a few bf16 ulps: rounding points
# Share of equal labels / grid cells, fused vs plain engine on the card in
# bf16: the two round at different points (the kernel keeps f32 between
# its stages), so argmax near-ties of the seeded random weights flip; a
# CPU rehearsal of this run measured 0.9936 labels / 0.9949 cells.
AGREE_BF16 = 0.98
# The same in f32 (TF32 off), the card's fused engine vs the CPU's plain one.
AGREE_F32 = 0.999
F32_LOGIT_ATOL = 1e-3

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


def main() -> int:
    faulthandler.dump_traceback_later(DEADLINE_S, exit=True)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU host",
              file=sys.stderr)
        return 2
    try:
        import bugcar_image_segmentation_tpu_torch as port
    except ImportError as exc:
        print(f"chip_smoke: the port package is not importable ({exc}); "
              f"run from the root of a checkout", file=sys.stderr)
        return 2
    import numpy as np
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import (
        fused_bottleneck_ref, launch_args)

    # float32 on the card means float32: cuDNN convs default to TF32.
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # -- env -----------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    emit("env", nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count(), cudnn_allow_tf32=False,
         float32_matmul_precision="highest")

    # -- build ---------------------------------------------------------------
    t = time.perf_counter()
    lib = kbuild.library()
    ptxas = [ln.strip() for ln in kbuild.build_log.splitlines()
             if "registers" in ln or "spill" in ln]
    emit("build", seconds=round(time.perf_counter() - t, 3),
         nvcc_seconds=kbuild.build_seconds, ptxas=ptxas)

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
    for dt in ("bfloat16", "float32"):
        fused = eng[("enet_fused", dt)]
        atol, rtol = TOL[dt]
        for n in (1, 4):
            with torch.no_grad():
                x = pre.preprocess_for_config(
                    torch.as_tensor(np.stack(frames[:n])).to(dev), fused.cfg)
                x, _, _ = fused.module.encode(x)
                x = x.permute(0, 2, 3, 1).contiguous()   # trunk input, NHWC
                for i, blk in enumerate(fused.forward_fn.blocks):
                    args = (blk.wp, blk.s1, blk.b1, blk.a1, blk.wcore(),
                            blk.s2, blk.b2, blk.a2, blk.we, blk.s3, blk.b3,
                            blk.ao)
                    kw = dict(kind=blk.kind, dilation=blk.dilation)
                    got = blk(x)
                    ref = fused_bottleneck_ref(x, *args, **kw)
                    torch.cuda.synchronize()
                    diff = (got.float() - ref.float()).abs()
                    lim = atol + rtol * ref.float().abs()
                    err = float(diff.max())
                    if not bool(torch.isfinite(got.float()).all()):
                        fail(f"kernel output not finite ({dt}, n={n}, "
                             f"block {i})")
                    if bool((diff > lim).any()):
                        fail(f"fused_bottleneck {blk.kind} d={blk.dilation} "
                             f"{dt} n={n}: max |err| {err} exceeds "
                             f"{atol} + {rtol}*|ref|")
                    key = (dt, n)
                    worst[key] = max(worst.get(key, 0.0), err)
                    rec = dict(dtype=dt, n=n, block=i, kind=blk.kind,
                               dilation=blk.dilation, max_abs_err=err)
                    if dt == "bfloat16":
                        xi, out = x, torch.empty_like(x)
                        raw, keep = launch_args(xi, out, *args, **kw)
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
                              kind=blk.kind, dilation=blk.dilation)
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
         max_abs_err={f"{dt}/n={n}": e for (dt, n), e in worst.items()},
         trunk_16_launches_ms=trunk_ms,
         trunk_through_wrapper_ms=trunk_wrapper_ms,
         trunk_plain_ms=trunk_plain_ms,
         trunk_bound_ms=trunk_bound_ms)
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
    # one launch per trunk block per backbone batch: 16 per frame at
    # batch 1, 16 for the 4-frame batch
    forwarded = 1 + len(frames) + 4
    batches = 1 + len(frames) + 1
    if launches["fused_bottleneck"] != 16 * batches:
        fail(f"fused_bottleneck launched {launches['fused_bottleneck']} "
             f"times for {batches} backbone batches; expected "
             f"{16 * batches}")
    want = (grid_cfg.cells_h, grid_cfg.cells_w)
    for name, g in (("single", single[None]), ("stream", streamed),
                    ("batch", batched)):
        if g.dtype != np.int8 or g.shape[1:] != want:
            fail(f"{name} grids are {g.dtype} {g.shape}, want int8 {want}")
        if not set(np.unique(g).tolist()) <= {-1, 0, 100}:
            fail(f"{name} grid values {np.unique(g)} not in {{-1, 0, 100}}")
    # cuDNN may pick other algorithms for a batch of 4 than for 1, so the
    # bf16 grids of the two runs may differ at argmax near-ties.
    same_single = float((single == streamed[0]).mean())
    same_batch = float((batched == streamed[:4]).mean())
    if min(same_single, same_batch) < AGREE_BF16:
        fail(f"pipe(frame) / run_batch agree with stream on {same_single} / "
             f"{same_batch} of cells; budget {AGREE_BF16}")

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

    # fused f32 on the card vs the port's plain f32 engine on the CPU
    cpu_eng = port.build_engine("enet", cfg32, variables=variables,
                                device="cpu")
    with torch.no_grad():
        lg_card = eng[("enet_fused", "float32")].logits(frames[0]).cpu()
        lg_cpu = cpu_eng.logits(frames[0])
    f32_err = float((lg_card - lg_cpu).abs().max())
    f32_label_agree = float((lg_card.argmax(-1) == lg_cpu.argmax(-1))
                            .float().mean())
    if not bool(torch.isfinite(lg_card).all()):
        fail("float32 logits on the card are not finite")
    if f32_err > F32_LOGIT_ATOL or f32_label_agree < AGREE_F32:
        fail(f"enet_fused f32 on the card vs enet f32 on the CPU: max "
             f"|logit err| {f32_err} (budget {F32_LOGIT_ATOL}), labels "
             f"agree {f32_label_agree} (budget {AGREE_F32})")

    # speed: host clock around work that ends in a device sync; the two
    # engines take turns (fused, plain, plain, fused, ...) so that drift on
    # the shared host falls on both; medians and quartiles over the rounds
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
               for k in ("enet_fused", "enet")}
    for r in range(SPEED_ROUNDS):
        order = (("enet_fused", pipe), ("enet", plain))
        for label, p in (order if r % 2 == 0 else order[::-1]):
            got = samples[label]
            got["ms_per_frame"] += [frame_ms(p, r * 4 + i) for i in range(4)]
            got["stream_fps"].append(stream_fps(p))
            got["batch4_ms"].append(batch_ms(p))
    speed = {label: {m: dict(zip(("q25", "median", "q75"),
                                 np.percentile(v, [25, 50, 75]).tolist()))
                     for m, v in got.items()}
             for label, got in samples.items()}
    emit("path", seconds=round(time.perf_counter() - t, 3),
         frames_forwarded=forwarded, backbone_batches=batches,
         launches=launches,
         grid_shape=list(want), single_vs_stream_cells=same_single,
         batch_vs_stream_cells=same_batch, label_agree_bf16=label_agree,
         cell_agree_bf16=cell_agree, f32_card_vs_cpu_max_logit_err=f32_err,
         f32_card_vs_cpu_label_agree=f32_label_agree, speed=speed,
         nvidia_smi=smi)

    # -- result --------------------------------------------------------------
    main_recs = [r for r in per_block
                 if r["dtype"] == "bfloat16" and r["n"] == 1]
    kernels = [{
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
    }]
    assert len(main_recs) == len(blocks)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
