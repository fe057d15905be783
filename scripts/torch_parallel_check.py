#!/usr/bin/env python3
"""The port's parallel paths in several processes, each held against the
one-process program.

    python3 scripts/torch_parallel_check.py [--world 2] [--device cuda|cpu]
        [--out results.json]

starts ``--world`` ranks of this script (a gloo group: on a one-card host
every rank shares the card, which NCCL refuses) and, at the serving
widths, runs in each:

1. ``rig`` — ``ShardedMultiCameraPipeline`` on ``enet_fused_w16`` (bf16),
   4 cameras at 512x256 (640x480 frames), its stitched grid against the
   one-process ``MultiCameraPipeline``'s: bit-equal;
2. ``tp`` — ``shard_engine_tp`` on ``enet_fused`` (f32, TF32 off) at
   512x256, its labels against the unsharded engine's: equal;
3. ``spatial`` — ``shard_engine_spatial`` on ``enet`` at 512x256 and
   ``segformer_b0`` at 1024x1024 (f32, the plain attention for both
   programs), labels against the unsharded engine's: equal;
4. ``train`` — one dp1 x sp``world`` ENet step (SGD, f32, batch 4,
   512x256, cuDNN's deterministic algorithms) against the one-process
   step: loss within 1e-5 relative and parameters within rtol 1e-4 / atol
   5e-6 (the JAX package's tolerances for its sharded step), each
   gradient leaf within 5e-2 relative L2 (the port's gradient budget,
   tests/test_torch_training_models.py: the split convs run other cuDNN
   algorithms, and ReLU / max-pool kinks move the first conv's kernel
   gradient most; the worst leaf is recorded);
5. ``artifact`` — the spatial ENet exported (``deploy.export_engine_to``)
   on rank 0, loaded by every rank and run with ``call_sharded``: labels
   equal to the live spatial engine's and to the unsharded engine's.

Wherever labels are held against the unsharded engine's, that engine's
labels must hold more than one class (random weights could give a map of
one class, which any fault would leave unchanged).

Each part records the ``fused_bottleneck`` launches of its sharded run
(counts reset just before it, read just after) and, where it serves, ms a
frame of the sharded program beside the one-process program's, taking
turns — with several ranks on one card these are processes sharing one
card, not a scaling result.  It prints one JSON object (rank 0's results,
with every rank's launch counts) and exits non-zero if a part failed on
any rank.  ``run(world, device)`` does the same in-process
(``chip_smoke.py``'s ``parallel_path``).
"""

import argparse
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

SEED = 0
FRAME_HW = (480, 640)
RIG_YAWS = (-0.6, -0.2, 0.2, 0.6)
ENET_HW = (256, 512)
SEGFORMER_HW = (1024, 1024)
TRAIN_BATCH = 4
TRAIN_LR = 1e-2
TIMED_ROUNDS = 5
GRAD_L2 = 5e-2
TIMEOUT_S = 600


def _sync(device: str) -> None:
    import torch
    if device == "cuda":
        torch.cuda.synchronize()


def _turns(runs: dict, device: str) -> dict:
    """Median host ms of each ``name: fn`` (ending in a device sync),
    taking turns; every rank runs the same turns."""
    import numpy as np
    samples = {name: [] for name in runs}
    for r in range(TIMED_ROUNDS * 2):
        for name in (list(runs) if r % 2 == 0 else list(runs)[::-1]):
            t = time.perf_counter()
            runs[name]()
            _sync(device)
            samples[name].append(1e3 * (time.perf_counter() - t))
    return {f"{name}_ms": float(np.median(v)) for name, v in samples.items()}


def _enet_cfg(name: str, dtype: str):
    import bugcar_image_segmentation_tpu_torch as port
    return port.ModelConfig(name=name, input_width=ENET_HW[1],
                            input_height=ENET_HW[0], dtype=dtype)


def _launches() -> int:
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    return int(kcuda.LAUNCHES.get("fused_bottleneck", 0))


def _agreement(got, want) -> dict:
    """The share of the labels ``got`` equal to the unsharded ``want``,
    and the classes ``want`` holds."""
    return {"label_agree": float((got == want).float().mean()),
            "classes": int(want.unique().numel())}


def rig_part(mesh, device: str) -> dict:
    import numpy as np

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    from bugcar_image_segmentation_tpu_torch.parallel import \
        ShardedMultiCameraPipeline

    frames = np.stack([f for f, _, _ in synthetic.video(
        seed=SEED, num_frames=len(RIG_YAWS), shape=FRAME_HW)])
    cals = [toy_calibration(ENET_HW, yaw=y) for y in RIG_YAWS]
    grid_cfg = port.GridConfig(8.0, 8.0, 0.1)
    eng = port.build_engine("enet_fused_w16", _enet_cfg(
        "enet_fused_w16", "bfloat16"), variables=random_enet_variables(SEED),
        device=device)
    local = port.MultiCameraPipeline(eng, cals, grid_cfg)
    sharded = ShardedMultiCameraPipeline(eng, cals, grid_cfg, mesh)
    want = local(frames).cpu().numpy()
    sharded(frames)
    _sync(device)
    kcuda.reset_launches()
    got = sharded(frames).cpu().numpy()
    launches = _launches()
    return {"cameras": len(cals), "grid_equal": bool(np.array_equal(
        got, want)), "grid_values": np.unique(got).tolist(),
        "launches": launches,
        **_turns({"sharded": lambda: sharded(frames),
                  "one_process": lambda: local(frames)}, device)}


def tp_part(mesh, device: str, frame) -> dict:
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
    from bugcar_image_segmentation_tpu_torch.parallel import shard_engine_tp

    def engine():
        return port.build_engine(
            "enet_fused", _enet_cfg("enet_fused", "float32"),
            variables=random_enet_variables(SEED), device=device)

    plain, tp = engine(), shard_engine_tp(engine(), mesh)
    want = plain.predict(frame)
    tp.predict(frame)
    _sync(device)
    kcuda.reset_launches()
    got = tp.predict(frame)
    launches = _launches()
    held = sum(t.numel() for m in tp.module.modules()
               for n in getattr(m, "_tp_leaves", {}) for t in [getattr(m, n)])
    return {**_agreement(got, want),
            "launches": launches, "sliced_elements_held": held,
            **_turns({"sharded": lambda: tp.predict(frame),
                      "one_process": lambda: plain.predict(frame)}, device)}


def spatial_part(mesh, device: str, frame) -> dict:
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
        random_segformer_variables
    from bugcar_image_segmentation_tpu_torch.parallel import \
        shard_engine_spatial

    out = {}
    for name, hw, make in (
            ("enet", ENET_HW, lambda: random_enet_variables(SEED)),
            ("segformer_b0", SEGFORMER_HW,
             lambda: random_segformer_variables(SEED, "b0"))):
        cfg = port.ModelConfig(name=name, input_width=hw[1],
                               input_height=hw[0], dtype="float32")
        plain = port.build_engine(name, cfg, variables=make(),
                                  device=device)
        if name == "segformer_b0":
            plain.module.xla_attention = True
        sp = shard_engine_spatial(port.build_engine(
            name, cfg, variables=make(), device=device), mesh)
        want, got = plain.predict(frame), sp.predict(frame)
        out[name] = {"input_hw": list(hw), **_agreement(got, want),
                     **_turns({"sharded": lambda: sp.predict(frame),
                               "one_process": lambda: plain.predict(frame)},
                              device)}
    return out


def train_part(mesh, device: str) -> dict:
    import numpy as np
    import torch

    from bugcar_image_segmentation_tpu_torch.models.enet import ENet
    from bugcar_image_segmentation_tpu_torch.parallel import (
        replicate, shard_batch_spatial)
    from bugcar_image_segmentation_tpu_torch.training import (
        SGD, create_train_state, make_train_step)

    rng = np.random.default_rng(SEED)
    images = rng.normal(size=(TRAIN_BATCH,) + ENET_HW + (3,)).astype(
        np.float32)
    labels = rng.integers(0, 15, (TRAIN_BATCH,) + ENET_HW).astype(np.int64)
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for m in (None, mesh):
            model = ENet(15)
            state = create_train_state(model, (1,) + ENET_HW + (3,),
                                       optimizer=SGD(TRAIN_LR), seed=SEED,
                                       device=device)
            if m is None:
                x = torch.from_numpy(images).to(device)
                y = torch.from_numpy(labels).to(device)
            else:
                replicate(state, m)
                x, y = shard_batch_spatial((images, labels), m)
            step = make_train_step(model, mesh=m)
            gen = torch.Generator().manual_seed(SEED)
            t = time.perf_counter()
            state, loss = step(state, x, y, gen)
            _sync(device)
            ms = 1e3 * (time.perf_counter() - t)
            out.append((float(loss), ms,
                        {k: v.detach().cpu().double() for k, v in
                         model.state_dict().items()},
                        {k: p.grad.detach().cpu().double() for k, p in
                         model.named_parameters()}))
    finally:
        torch.backends.cudnn.deterministic = False
    (l0, ms0, sd0, g0), (l1, ms1, sd1, g1) = out
    params_ok = all(torch.allclose(sd1[k], v, rtol=1e-4, atol=5e-6)
                    for k, v in sd0.items())
    top = max(float(g.norm()) for g in g0.values())
    grad_err = {k: float((g1[k] - g).norm()) / max(float(g.norm()),
                                                    1e-6 * top)
                for k, g in g0.items()}
    worst = max(grad_err, key=grad_err.get)
    return {"batch": TRAIN_BATCH, "loss": l1, "one_process_loss": l0,
            "loss_rel_err": abs(l1 - l0) / abs(l0), "params_ok": params_ok,
            "grad_rel_l2_max": grad_err[worst], "grad_worst_leaf": worst,
            "step_ms": ms1, "one_process_step_ms": ms0}


def artifact_part(mesh, device: str, folder: str, frame) -> dict:
    import torch

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import deploy
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.ops.host_resize import \
        resize_linear
    from bugcar_image_segmentation_tpu_torch.parallel import \
        shard_engine_spatial

    cfg = _enet_cfg("enet", "float32")
    variables = random_enet_variables(SEED)
    plain = port.build_engine("enet", cfg, variables=variables,
                              device=device)
    sp = shard_engine_spatial(port.build_engine(
        "enet", cfg, variables=variables, device=device), mesh)
    path = os.path.join(folder, "enet_spatial.bcseg")
    t = time.perf_counter()
    if mesh.rank == 0:
        deploy.export_engine_to(path, sp, batch=1)
    torch.distributed.barrier()
    export_s = time.perf_counter() - t
    dep = deploy.load_artifact(path)
    x = resize_linear(frame, ENET_HW)[None]
    got = dep.call_sharded(mesh, x)
    live, want = sp.predict(x), plain.predict(x)
    return {"nr_devices": dep.nr_devices, "export_seconds": export_s,
            "equal_live": bool(torch.equal(got, live)),
            **_agreement(got, want),
            **_turns({"artifact": lambda: dep.call_sharded(mesh, x),
                      "live": lambda: sp.predict(x)}, device)}


def worker(rank: int, world: int, port: int, folder: str,
           device: str) -> None:
    import numpy as np
    import torch

    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.parallel import make_mesh

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if device == "cpu":
        torch.set_num_threads(1)
    mesh_args = dict(n_devices=world, rank=rank, device=device,
                     backend="gloo", init_method=f"tcp://localhost:{port}",
                     timeout_s=TIMEOUT_S / 2)
    data = make_mesh(axes=("data",), **mesh_args)
    frame = synthetic.road_scene(np.random.default_rng(SEED), FRAME_HW)[0]
    out = {"rank": rank, "world": world}
    try:
        t = time.perf_counter()
        out["rig"] = rig_part(data, device)
        out["tp"] = tp_part(make_mesh(axes=("model",), **mesh_args), device,
                            frame)
        space = make_mesh(axes=("space",), **mesh_args)
        out["spatial"] = spatial_part(space, device, frame)
        out["train"] = train_part(make_mesh(
            axes=("data", "space"), shape=(1, world), **mesh_args), device)
        out["artifact"] = artifact_part(space, device, folder, frame)
        out["seconds"] = time.perf_counter() - t
    finally:
        with open(os.path.join(folder, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        data.close()


def failures(result: dict) -> list:
    """What a rank's results fail, as messages."""
    bad = []
    if not result["rig"]["grid_equal"]:
        bad.append("rig: the sharded grid differs from the one-process one")
    for what, rec in [("tp", result["tp"]),
                      *[(f"spatial {k}", v)
                        for k, v in result["spatial"].items()],
                      ("artifact", result["artifact"])]:
        if rec["label_agree"] != 1.0:
            bad.append(f"{what}: labels agree on {rec['label_agree']}, "
                       f"not all")
        if rec["classes"] < 2:
            bad.append(f"{what}: the unsharded labels hold "
                       f"{rec['classes']} class")
    if not result["artifact"]["equal_live"]:
        bad.append("artifact: labels differ from the live spatial engine's")
    tr = result["train"]
    if tr["loss_rel_err"] > 1e-5 or not tr["params_ok"] \
            or tr["grad_rel_l2_max"] > GRAD_L2:
        bad.append(f"train: {tr}")
    return bad


def run(world: int = 2, device: str = "cuda") -> dict:
    """Start ``world`` ranks, wait for them, and return rank 0's results
    with every rank's launch counts; raises RuntimeError if a rank failed
    or a part failed its check."""
    if device == "cuda":
        from bugcar_image_segmentation_tpu_torch.ops.cuda import build
        build.library()     # once, before the ranks load it
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with tempfile.TemporaryDirectory() as folder:
        env = dict(os.environ, LOCAL_RANK="0")
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(r),
             "--world", str(world), "--port", str(port), "--folder", folder,
             "--device", device], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for r in range(world)]
        errors = []
        for r, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=TIMEOUT_S)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                _, err = p.communicate()
                errors.append(f"rank {r} timed out: {err[-3000:]}")
                continue
            if p.returncode:
                errors.append(f"rank {r} exited {p.returncode}: "
                              f"{err[-3000:]}")
        if errors:
            raise RuntimeError("\n".join(errors))
        results = []
        for r in range(world):
            with open(os.path.join(folder, f"rank{r}.json")) as f:
                results.append(json.load(f))
    bad = [f"rank {r['rank']}: {msg}" for r in results
           for msg in failures(r)]
    if bad:
        raise RuntimeError("; ".join(bad))
    out = dict(results[0])
    out["launches_by_rank"] = [
        {"rig": r["rig"]["launches"], "tp": r["tp"]["launches"]}
        for r in results]
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse
                                .RawDescriptionHelpFormatter)
    p.add_argument("--world", type=int, default=2)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--out", help="also write the JSON here")
    p.add_argument("--rank", type=int, help=argparse.SUPPRESS)
    p.add_argument("--port", type=int, help=argparse.SUPPRESS)
    p.add_argument("--folder", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.rank is not None:
        worker(args.rank, args.world, args.port, args.folder, args.device)
        return 0
    if args.device == "cuda":
        import torch
        if not torch.cuda.is_available():
            p.error("no CUDA card here; pass --device cpu")
    result = run(args.world, args.device)
    text = json.dumps(result)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
