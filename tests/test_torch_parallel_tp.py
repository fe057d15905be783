"""The port's tensor parallelism (``parallel/tp.py``) in gloo processes on
the CPU, against the unsharded port and the JAX package's unsharded
engine and step.

- ``tp_spec_for`` decides as JAX's does, leaf by leaf, on ENet's and
  UNet's Flax trees, over model axes of 2 and 4 and at ``min_channels``
  64 and 8, and on the shapes of JAX's own unit test.
- Serving over a model axis of 4 ranks at ``min_channels=8`` (so that the
  small net shards): ENet's labels in f32 at 32x64 equal the unsharded
  engine's and the JAX engine's, for a batch and for one frame; a rank
  holds its sliced leaves at 1/4 of their size; after ``load_variables``
  of another tree the engine is sliced the same way and its labels are
  that tree's; ``enet_fused`` (the bottleneck kernel's arguments gathered
  whole before each launch) gives the same labels.  SegFormer's folded
  head (``_hc``, ``_int8``) is refused.
- dp x tp training: one SGD step of UNet at 32x64, batch 8, on a (2, 2)
  ("data", "model") mesh from one tree, held to the one-process step with
  the JAX package's tolerances for its dp x tp step
  (tests/test_parallel.py:119: loss within 1e-5 relative, parameters
  within rtol 1e-4 and atol 5e-6; each leaf's gradient within 2e-2
  relative L2, measured 3.6e-3: tests/test_torch_parallel_spatial_train.py
  says why), and to the JAX step in float64 as that file holds the
  spatial steps.
"""

import os

import numpy as np
import pytest
import torch

import torch_gloo
from torch_gloo import one_thread  # noqa: F401

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from bugcar_image_segmentation_tpu.configs import ModelConfig as JModel
    from bugcar_image_segmentation_tpu.models.api import \
        build_engine as jbuild
    from bugcar_image_segmentation_tpu.models.unet import UNet as JUNet
    from bugcar_image_segmentation_tpu.parallel import make_mesh as jmesh
    from bugcar_image_segmentation_tpu.parallel import \
        tp_spec_for as jspec
    from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
        flax_variables
    from test_torch_parallel_spatial_train import (check_against_jax,
                                                   grads_close,
                                                   jax_sgd_step, port_trees)
    from test_torch_parallel_spatial_train import GRAD_SPLIT

import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_unet import \
    random_unet_variables
from bugcar_image_segmentation_tpu_torch.models.unet import UNet
from bugcar_image_segmentation_tpu_torch.parallel import (
    make_mesh, replicate, shard_batch, shard_engine_tp, shard_params_tp,
    tp_spec_for)
from bugcar_image_segmentation_tpu_torch.parallel.tp import whole_state_dict
from bugcar_image_segmentation_tpu_torch.training import (
    SGD, create_train_state, make_train_step)

HW = (32, 64)
LR = 1e-2
TREES = (21, 5)      # the served tree's seed, then the hot-swapped one's


def frames():
    rng = np.random.default_rng(9)
    return rng.integers(0, 256, (2,) + HW + (3,), np.uint8)


def cfg(name: str):
    return port.ModelConfig(name=name, input_width=HW[1],
                            input_height=HW[0], dtype="float32")


def train_inputs():
    rng = np.random.default_rng(2)
    images = rng.normal(size=(8,) + HW + (3,)).astype(np.float32)
    labels = rng.integers(0, 15, (8,) + HW).astype(np.int64)
    return images, labels


def start_unet():
    model = UNet(15)
    state = create_train_state(model, (1,) + HW + (3,), optimizer=SGD(LR),
                               seed=3, device="cpu")
    return model, state


def sliced_sizes(module: torch.nn.Module):
    """(elements held, elements whole) over the sliced leaves."""
    held = whole = 0
    for mod in module.modules():
        for name in getattr(mod, "_tp_leaves", {}):
            t = getattr(mod, name)
            held += t.numel()
            whole += t.numel() * mod._tp_axis.size
    return held, whole


@torch.no_grad()
def whole_grads(model: torch.nn.Module):
    """Every parameter's gradient, the sliced ones gathered whole."""
    out = {}
    for prefix, mod in model.named_modules():
        leaves = getattr(mod, "_tp_leaves", {})
        for name, p in mod._parameters.items():
            g = (mod._tp_axis.gather(p.grad, leaves[name])
                 if name in leaves else p.grad)
            out[f"{prefix}.{name}" if prefix else name] = g.clone()
    return out


def worker(mesh_args: dict, folder: str, case: str) -> None:
    mesh = make_mesh(axes=("model",), **mesh_args)
    rank = mesh.rank
    out = {}
    try:
        if case == "serve":
            x = frames()
            eng = port.build_engine(
                "enet", cfg("enet"), device="cpu",
                variables=random_enet_variables(TREES[0]))
            shard_engine_tp(eng, mesh, min_channels=8)
            out["labels"] = eng.predict(x).numpy()
            out["single"] = eng.predict(x[0]).numpy()
            out["held"], out["whole"] = sliced_sizes(eng.module)
            eng.load_variables(random_enet_variables(TREES[1]))
            out["swapped"] = eng.predict(x).numpy()
            out["held_swapped"], _ = sliced_sizes(eng.module)
            fused = port.build_engine(
                "enet_fused", cfg("enet_fused"), device="cpu",
                variables=random_enet_variables(TREES[0]))
            shard_engine_tp(fused, mesh, min_channels=8)
            out["fused"] = fused.predict(x).numpy()
            out["fused_held"], _ = sliced_sizes(fused.forward_fn)
        else:
            dp_tp = make_mesh(axes=("data", "model"), shape=(2, 2),
                              **mesh_args)
            model, state = start_unet()
            replicate(state, dp_tp)
            shard_params_tp(state, dp_tp)
            out["held"], out["whole"] = sliced_sizes(model)
            x, y = shard_batch(train_inputs(), dp_tp)
            state, loss = make_train_step(model, mesh=dp_tp)(state, x, y)
            out["loss"] = float(loss)
            out.update({"sd_" + k: v.numpy()
                        for k, v in whole_state_dict(model).items()})
            out.update({"g_" + k: g.numpy()
                        for k, g in whole_grads(model).items()})
        np.savez(os.path.join(folder, f"{case}_rank{rank}.npz"), **out)
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("tp"))
    out = {}
    torch_gloo.run_ranks(__file__, folder, (4, "serve"), (4, "train"))
    for case in ("serve", "train"):
        out[case] = [dict(np.load(os.path.join(folder,
                                                f"{case}_rank{r}.npz")))
                     for r in range(4)]
    return out


def flax_shapes(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flax_shapes(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


@pytest.mark.parametrize("model", ["enet", "unet"])
@pytest.mark.parametrize("size,min_channels", [(2, 64), (2, 8), (4, 64),
                                               (4, 8)])
def test_tp_spec_for_agrees_with_jax(model, size, min_channels):
    tree = (random_enet_variables(0) if model == "enet"
            else random_unet_variables(0))
    mesh = jmesh(8, axes=("data", "model"), shape=(8 // size, size))
    sharded = 0
    for coll in ("params", "batch_stats"):
        for path, leaf in flax_shapes(tree[coll]):
            spec = jspec(path, leaf, mesh, min_channels=min_channels)
            want = (spec.index("model") if "model" in tuple(spec)
                    else None)
            got = tp_spec_for(path, leaf.shape, size, min_channels)
            assert got == want, (path, leaf.shape, got, spec)
            sharded += got is not None
    assert sharded > 0


def test_tp_spec_for_known_shapes():
    assert tp_spec_for(("Conv_0", "kernel"), (3, 3, 64, 128), 2) == 3
    assert tp_spec_for(("Dense_0", "kernel"), (256, 128), 2) == 1
    assert tp_spec_for(("Conv_0", "bias"), (128,), 2) == 0
    assert tp_spec_for(("BatchNorm_0", "scale"), (128,), 2) == 0
    assert tp_spec_for(("Conv_0", "kernel"), (3, 3, 3, 16), 2) is None
    assert tp_spec_for(("Conv_0", "kernel"), (3, 3, 64, 129), 2) is None
    assert tp_spec_for(("count",), (), 2) is None


def test_tp_refuses_the_folded_segformer_head():
    from bugcar_image_segmentation_tpu_torch.parallel import Mesh
    eng = port.build_engine("segformer_b0_hc", port.ModelConfig(
        name="segformer_b0_hc", input_width=64, input_height=64,
        dtype="float32"), device="cpu")
    mesh = Mesh(rank=0, world_size=2, device=torch.device("cpu"),
                axis_names=("model",))
    with pytest.raises(ValueError, match="folded SegFormer head"):
        shard_engine_tp(eng, mesh)


@pytest.fixture(scope="module")
def jax_labels():
    x = frames()
    out = []
    for seed in TREES:
        jeng = jbuild("enet", JModel(name="enet", input_width=HW[1],
                                     input_height=HW[0], dtype="float32"),
                      variables=jax.tree_util.tree_map(
                          jnp.asarray, random_enet_variables(seed)))
        out.append(np.asarray(jeng.predict(x)))
    return out


def test_tp_serving_labels_equal_unsharded_and_jax(ranks, jax_labels):
    x = frames()
    eng = port.build_engine("enet", cfg("enet"), device="cpu",
                            variables=random_enet_variables(TREES[0]))
    want = eng.predict(x).numpy()
    assert np.array_equal(want, jax_labels[0])
    for r in ranks["serve"]:
        assert np.array_equal(r["labels"], want)
        assert np.array_equal(r["single"], want[0])
        assert np.array_equal(r["fused"], want)


def test_tp_slices_are_held_and_survive_load_variables(ranks, jax_labels):
    for r in ranks["serve"]:
        assert r["held"] * 4 == r["whole"] > 0
        assert r["held_swapped"] == r["held"]
        assert r["fused_held"] > r["held"]      # the kernel arguments too
        assert np.array_equal(r["swapped"], jax_labels[1])


@pytest.fixture(scope="module")
def unet_steps(ranks):
    images, labels = train_inputs()
    model, state = start_unet()
    before = flax_variables(model)
    want = jax_sgd_step(JUNet(num_classes=15, dtype=jnp.float64), before,
                        images, labels, LR)
    state, loss = make_train_step(model)(state, torch.from_numpy(images),
                                         torch.from_numpy(labels))
    one = {"loss": float(loss)}
    one.update({"sd_" + k: v.numpy() for k, v in model.state_dict().items()})
    one.update({"g_" + k: p.grad.numpy()
                for k, p in model.named_parameters()})
    return ranks["train"], one, before, want


def test_dp_tp_step_equals_one_process_step(unet_steps):
    got, one, _, _ = unet_steps
    for r in got:
        assert r["held"] * 2 == r["whole"] > 0
        assert abs(r["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        for k, v in one.items():
            if k.startswith("sd_"):
                np.testing.assert_allclose(r[k], v, rtol=1e-4, atol=5e-6,
                                           err_msg=k)
        grads_close(r, one, GRAD_SPLIT)


def test_dp_tp_step_equals_jax_step(unet_steps):
    got, _, _, want = unet_steps
    after, grads = port_trees(lambda: UNet(15), got[0])
    check_against_jax(after, grads, got[0]["loss"], want)


if __name__ == "__main__":
    torch_gloo.main(worker)
