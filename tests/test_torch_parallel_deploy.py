"""Sharded artifacts (``deploy.py``: a spatially partitioned engine's
``torch.export`` program, ``Deployed.call_sharded``) and the CLIs'
``--spatial`` options, in gloo processes on the CPU.

- An ENet spatial artifact over 4 ranks (f32, 32x64, batch 2), exported
  on rank 0 alone and loaded by every rank: its header records
  ``nr_devices`` 4, and ``call_sharded`` gives every rank the unsharded
  engine's labels and the JAX engine's (the rank's coordinate is an input
  of the program, so rank 0's export serves ranks 1-3; the collectives
  resolve over the loading process's default group).
- A SegFormer-B0 ``logits`` artifact over 2 ranks (64x64, batch 1):
  within 1e-5 of the logits' largest magnitude of the unsharded engine
  with the plain attention (tests/test_torch_parallel_spatial.py's
  tolerance), and within rtol = atol = 1e-4 (the port's SegFormer
  tolerance against JAX) of the JAX package's unsharded engine with its
  plain attention and plain head, as the JAX spatial path serves it.
- A mesh of another size, and a plain call, are refused.
- ``scripts/torch_export_model.py --spatial 2`` (then ``--load --smoke``
  on 2 ranks) and ``scripts/torch_train.py --devices 2 --spatial 2``
  run under ``torchrun``'s environment variables, in-process.
"""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

import torch_gloo
from torch_gloo import one_thread  # noqa: F401

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from bugcar_image_segmentation_tpu.configs import ModelConfig as JModel
    from bugcar_image_segmentation_tpu.models.api import (
        Engine as JEngine, build_engine as jbuild)

import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import deploy
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
    random_segformer_variables
from bugcar_image_segmentation_tpu_torch.parallel import (
    Mesh, make_mesh, shard_engine_spatial)
from bugcar_image_segmentation_tpu_torch.utils.checkpoint import (
    load_variables, save_variables)

LOGIT_TOL = 1e-5
JAX_RTOL = JAX_ATOL = 1e-4      # tests/test_torch_segformer.py's
# name: (variables, (H, W), ranks, endpoint, batch)
ARTIFACTS = {
    "enet": (lambda: random_enet_variables(21), (32, 64), 4, "predict", 2),
    "segformer_b0": (lambda: random_segformer_variables(4, "b0"), (64, 64),
                     2, "logits", 1),
}
CLI_HW = (32, 64)


def engine(name: str):
    make, hw, *_ = ARTIFACTS[name]
    cfg = port.ModelConfig(name=name, input_width=hw[1], input_height=hw[0],
                           dtype="float32")
    return port.build_engine(name, cfg, variables=make(), device="cpu")


def frames(name: str):
    _, hw, _, _, batch = ARTIFACTS[name]
    rng = np.random.default_rng(12)
    return rng.integers(0, 256, (batch,) + hw + (3,), np.uint8)


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(torch_gloo.REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def torchrun_env(mesh_args: dict) -> None:
    """The environment ``torchrun`` gives a rank."""
    port_ = mesh_args["init_method"].rsplit(":", 1)[1]
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=port_,
                      RANK=str(mesh_args["rank"]), LOCAL_RANK="0",
                      WORLD_SIZE=str(mesh_args["n_devices"]))


def write_dataset(folder: str) -> None:
    """Four .npy frame / label pairs, and an ENet checkpoint, at
    ``CLI_HW``."""
    save_variables(os.path.join(folder, "small.msgpack"),
                   random_enet_variables(0),
                   port.ModelConfig(input_width=CLI_HW[1],
                                    input_height=CLI_HW[0],
                                    dtype="float32"))
    rng = np.random.default_rng(0)
    for sub in ("images", "labels"):
        os.makedirs(os.path.join(folder, sub), exist_ok=True)
    for i in range(4):
        np.save(os.path.join(folder, "images", f"{i}.npy"),
                rng.integers(0, 256, CLI_HW + (3,), np.uint8))
        np.save(os.path.join(folder, "labels", f"{i}.npy"),
                rng.integers(0, 15, CLI_HW, np.uint8))


def worker(mesh_args: dict, folder: str, case: str) -> None:
    rank = mesh_args["rank"]
    if case == "cli":
        torchrun_env(mesh_args)
        cli = load_script("torch_export_model")
        path = os.path.join(folder, "cli_sp.bcseg")
        cli.run(cli.parse_args(["--model", "enet", "--out", path,
                                "--checkpoint",
                                os.path.join(folder, "small.msgpack"),
                                "--spatial", "2", "--batch", "1",
                                "--device", "cpu"]))
        meta = cli.run(cli.parse_args(["--load", path, "--smoke"]))
        with open(os.path.join(folder, f"cli_rank{rank}.json"), "w") as f:
            json.dump(meta, f)
        train = load_script("torch_train")
        sys.argv = ["torch_train.py", "--model", "enet",
                    "--images", os.path.join(folder, "images"),
                    "--labels", os.path.join(folder, "labels"),
                    "--width", str(CLI_HW[1]), "--height", str(CLI_HW[0]),
                    "--steps", "2", "--batch", "2", "--devices", "2",
                    "--spatial", "2", "--device", "cpu",
                    "--out", os.path.join(folder, "sp.msgpack")]
        assert train.main() == 0
        return
    name = case
    mesh = make_mesh(axes=("space",), **mesh_args)
    try:
        _, _, _, fn, batch = ARTIFACTS[name]
        eng = shard_engine_spatial(engine(name), mesh)
        path = os.path.join(folder, f"{name}.bcseg")
        if rank == 0:
            deploy.export_engine_to(path, eng, fn=fn, batch=batch)
        torch.distributed.barrier()
        dep = deploy.load_artifact(path)
        out = {"nr_devices": dep.nr_devices,
               "got": dep.call_sharded(mesh, frames(name)).numpy(),
               "live": getattr(eng, "logits" if fn == "logits"
                               else "predict")(frames(name)).numpy()}
        np.savez(os.path.join(folder, f"{name}_rank{rank}.npz"), **out)
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("deploy"))
    write_dataset(folder)
    torch_gloo.run_ranks(__file__, folder, (2, "cli"), *(
        (world, name) for name, (_, _, world, _, _) in ARTIFACTS.items()))
    return folder


def rank_results(folder: str, name: str):
    world = ARTIFACTS[name][2]
    return [dict(np.load(os.path.join(folder, f"{name}_rank{r}.npz")))
            for r in range(world)]


def test_enet_artifact_gives_unsharded_labels(folder):
    x = frames("enet")
    want = engine("enet").predict(x).numpy()
    _, hw, *_ = ARTIFACTS["enet"]
    jeng = jbuild("enet", JModel(name="enet", input_width=hw[1],
                                 input_height=hw[0], dtype="float32"),
                  variables=jax.tree_util.tree_map(
                      jnp.asarray, random_enet_variables(21)))
    assert np.array_equal(want, np.asarray(jeng.predict(x)))
    for r in rank_results(folder, "enet"):
        assert int(r["nr_devices"]) == 4
        assert np.array_equal(r["got"], want)
        assert np.array_equal(r["live"], want)


def test_segformer_logits_artifact_within_tolerance(folder):
    eng = engine("segformer_b0")
    eng.module.xla_attention = True
    want = eng.logits(frames("segformer_b0")).numpy()
    make, hw, *_ = ARTIFACTS["segformer_b0"]
    cfg = JModel(name="segformer_b0", input_width=hw[1], input_height=hw[0],
                 dtype="float32")
    v = jax.tree_util.tree_map(jnp.asarray, make())
    jeng = JEngine(jbuild("segformer_b0", cfg, variables=v).module.clone(
        xla_attention=True, head_cascade=False), cfg, variables=v)
    jwant = np.asarray(jeng.logits(frames("segformer_b0")))
    for r in rank_results(folder, "segformer_b0"):
        assert int(r["nr_devices"]) == 2
        assert r["got"].shape == want.shape
        assert np.abs(r["got"] - want).max() <= LOGIT_TOL * np.abs(
            want).max()
        np.testing.assert_allclose(r["got"], jwant, rtol=JAX_RTOL,
                                   atol=JAX_ATOL)


def test_artifact_refuses_other_mesh_sizes(folder):
    dep = deploy.load_artifact(os.path.join(folder, "enet.bcseg"))
    assert dep.meta["nr_devices"] == 4
    with pytest.raises(ValueError, match="exported for 4 devices, mesh has "
                                         "2"):
        dep.call_sharded(Mesh(rank=0, world_size=2,
                              device=torch.device("cpu")), frames("enet"))
    with pytest.raises(ValueError, match="call_sharded"):
        dep(frames("enet"))


def test_cli_spatial_export_and_train(folder):
    for rank in range(2):
        with open(os.path.join(folder, f"cli_rank{rank}.json")) as f:
            meta = json.load(f)
        assert meta["nr_devices"] == 2
        assert meta["smoke_outputs"] == [[[1, *CLI_HW], "uint8"]]
    tree, cfg = load_variables(os.path.join(folder, "sp.msgpack"))
    assert (cfg.input_height, cfg.input_width) == CLI_HW
    kernel = tree["params"]["initial"]["Conv_0"]["kernel"]
    assert kernel.shape == (3, 3, 3, 13) and np.isfinite(kernel).all()


if __name__ == "__main__":
    torch_gloo.main(worker)
