"""The port's spatially partitioned train step (``parallel/spatial.py``,
``make_train_step(model, mesh=)`` over a ("data", "space") mesh) in gloo
processes on the CPU, against the one-process step and the JAX package's
unsharded step.

- ENet at 32x64, batch 4, on a (2, 4) mesh: each rank takes 2 samples'
  8 of 32 rows, so the 1/8-resolution trunk holds one row a rank and a
  dilation-16 core reads rows of every other rank; max-unpool, the
  transposed convs and the spatial-dropout masks (per sample, drawn for
  the global batch) cross the shards.
- SegFormer-B0 at 64x64, batch 4, on a (2, 2) mesh (its deepest stage
  holds 2 rows).

One SGD step (lr 1e-2, as tests/test_parallel.py: Adam's update would
magnify the last bits that a split sum moves) from one tree.  Against the
one-process port step, the JAX package's own tolerances for its sharded
step (tests/test_parallel.py:477-492, :537-552): loss within 1e-5
relative; parameters within rtol 1e-4 and atol 5e-6 (ENet) or 1e-5
(SegFormer); running statistics the same.  Besides, each leaf's gradient
within 2e-2 relative L2 (a leaf that is zero in exact arithmetic, below
1e-6 of the largest leaf's norm, relative to that): measured at most
2.3e-3 (ENet) and 5.5e-3 (SegFormer) in the first conv's kernel, whose
sums over every pixel pass ReLU and max-pool kinks that the split sums
round to other sides; a gradient scaled by the ranks or missing a shard's
share would be off by 0.5 or more.  Against the JAX step, which runs
in float64 (its float32 gradients move by ENet's and SegFormer's kinks,
tests/test_torch_training.py), as tests/test_torch_training_models.py
holds the one-process step: loss within 1e-5 relative, each leaf's update
(its gradient times the learning rate) within 5e-2 relative L2 of JAX's,
or below 1e-6 of the largest leaf's norm where JAX's is zero in exact
arithmetic, running statistics within 5e-5 of max(their leaf's max, 0.1).
"""

import os
import sys

import numpy as np
import pytest
import torch

import torch_gloo
from torch_gloo import one_thread  # noqa: F401

if __name__ != "__main__":
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax

    from bugcar_image_segmentation_tpu.models.enet import ENet as JENet
    from bugcar_image_segmentation_tpu.models.segformer import \
        SegFormer as JSegFormer
    from bugcar_image_segmentation_tpu.training import (
        TrainState as JTrainState, softmax_cross_entropy as jce)
    from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
        flax_variables

from bugcar_image_segmentation_tpu_torch.models.enet import ENet
from bugcar_image_segmentation_tpu_torch.models.segformer import SegFormer
from bugcar_image_segmentation_tpu_torch.parallel import (
    make_mesh, replicate, shard_batch_spatial)
from bugcar_image_segmentation_tpu_torch.training import (
    SGD, create_train_state, make_train_step)

LR = 1e-2
# (port model, JAX model by dtype, (H, W), batch, mesh shape, param atol)
CASES = {
    "enet": (lambda: ENet(15),
             lambda dt: JENet(num_classes=15, dtype=dt, fast=False),
             (32, 64), 4, (2, 4), 5e-6),
    "segformer": (lambda: SegFormer.preset("b0", num_classes=15),
                  lambda dt: JSegFormer.preset("b0", num_classes=15,
                                               dtype=dt, chw_stages=0,
                                               chw_head=False),
                  (64, 64), 4, (2, 2), 1e-5),
}
GRAD_L2, ZERO_GRAD, STATS_RTOL = 5e-2, 1e-6, 5e-5
# a split step's gradients against the one-process step's, relative L2
# (module docstring)
GRAD_SPLIT = 2e-2


def inputs(name: str):
    _, _, hw, batch, _, _ = CASES[name]
    rng = np.random.default_rng(3)
    images = rng.normal(size=(batch,) + hw + (3,)).astype(np.float32)
    labels = rng.integers(0, 15, (batch,) + hw).astype(np.int64)
    labels[-1, -3:] = 255
    return images, labels


def start(name: str):
    """The port model and its SGD train state, from seed 3."""
    make, _, hw, _, _, _ = CASES[name]
    model = make()
    state = create_train_state(model, (1,) + hw + (3,), optimizer=SGD(LR),
                               seed=3, device="cpu")
    return model, state


def masks_of(folder: str):
    data = np.load(os.path.join(folder, "masks.npz"))
    return {k: torch.from_numpy(data[k]) for k in data.files} or None


def worker(mesh_args: dict, folder: str, case: str) -> None:
    """One rank: one dp x sp step of ``case`` from the seeded tree."""
    *_, shape, _ = CASES[case]
    mesh = make_mesh(axes=("data", "space"), shape=shape, **mesh_args)
    try:
        model, state = start(case)
        replicate(state, mesh)
        x, y = shard_batch_spatial(inputs(case), mesh)
        step = make_train_step(model, mesh=mesh)
        state, loss = step(state, x, y, dropout=masks_of(folder))
        out = {"loss": float(loss)}
        out.update({"sd_" + k: v.numpy()
                    for k, v in model.state_dict().items()})
        out.update({"g_" + k: p.grad.numpy()
                    for k, p in model.named_parameters()})
        np.savez(os.path.join(folder, f"rank{mesh.rank}.npz"), **out)
    finally:
        mesh.close()


def recording_dropout(record):
    def intercept(next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            m = next_fun(jnp.ones_like(x), *args[1:], **kwargs)
            record[context.module.parent.name] = m
            return x * m
        return next_fun(*args, **kwargs)
    return intercept


def jax_sgd_step(jm, tree, images, labels, lr):
    """One step of the JAX package's train-step arithmetic with
    ``optax.sgd(lr)`` in float64, unsharded: (loss, the updated tree, the
    dropout masks as (N, C) float32, by bottleneck, the gradients)."""
    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        state = JTrainState.create(apply_fn=jm.apply,
                                   params=cast(tree["params"]),
                                   batch_stats=cast(tree["batch_stats"]),
                                   tx=optax.sgd(lr))

        def step(state, images, labels, key):
            def loss_fn(params):
                masks = {}
                with fnn.intercept_methods(recording_dropout(masks)):
                    logits, upd = jm.apply(
                        {"params": params, "batch_stats": state.batch_stats},
                        images, train=True, rngs={"dropout": key},
                        mutable=["batch_stats"])
                return jce(logits, labels), (upd["batch_stats"], masks)

            (loss, (stats, masks)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)
            new = state.apply_gradients(grads=grads).replace(
                batch_stats=stats)
            return new, loss, masks, grads

        new, loss, masks, grads = jax.jit(step)(
            state, jnp.asarray(images, jnp.float64), jnp.asarray(labels),
            jax.random.PRNGKey(7))
        tree = {"params": jax.tree_util.tree_map(np.asarray, new.params),
                "batch_stats": jax.tree_util.tree_map(np.asarray,
                                                      new.batch_stats)}
        return (float(loss), tree,
                {k: np.asarray(m, np.float32)[:, 0, 0, :]
                 for k, m in masks.items()},
                jax.tree_util.tree_map(np.asarray, grads))


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def l2_rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-30))


def port_trees(make, saved: dict):
    """A rank's saved state dict (``sd_``) and gradients (``g_``) → the
    Flax trees of the weights and of the gradients."""
    model = make()
    model.load_state_dict({k[3:]: torch.from_numpy(v)
                           for k, v in saved.items() if k.startswith("sd_")})
    twin = make()
    twin.load_state_dict({**model.state_dict(), **{
        k[2:]: torch.from_numpy(v) for k, v in saved.items()
        if k.startswith("g_")}})
    return flax_variables(model), flax_variables(twin)["params"]


def grads_close(got: dict, want: dict, rtol: float) -> None:
    """Every gradient leaf (``g_`` keys) of ``got`` within ``rtol``
    relative L2 of ``want``'s, a leaf whose norm is below ``ZERO_GRAD`` of
    the largest leaf's (zero in exact arithmetic) relative to that."""
    grads = {k: v for k, v in want.items() if k.startswith("g_")}
    top = max(np.linalg.norm(g) for g in grads.values())
    for k, g in grads.items():
        err = np.linalg.norm(np.asarray(got[k], np.float64) - g)
        assert err <= rtol * max(np.linalg.norm(g), ZERO_GRAD * top), k


def check_against_jax(after: dict, grads: dict, loss: float,
                      want) -> None:
    """A port step (the Flax tree after it, its gradients, its loss)
    against :func:`jax_sgd_step`'s result, with the tolerances of the
    module docstring."""
    jloss, jtree, _, jgrads = want
    assert abs(loss - jloss) <= 1e-5 * jloss
    jg = dict(leaves(jgrads))
    assert sorted(jg) == sorted(dict(leaves(grads)))
    top = max(np.linalg.norm(g) for g in jg.values())
    for k, g in leaves(grads):
        if np.linalg.norm(jg[k]) < 1e-8 * top:       # zero, exactly
            assert np.linalg.norm(g) <= ZERO_GRAD * top, k
        else:
            assert l2_rel(g, jg[k]) <= GRAD_L2, k
    jstats = dict(leaves(jtree["batch_stats"]))
    for k, s in leaves(after["batch_stats"]):
        assert np.abs(s - jstats[k]).max() <= STATS_RTOL * max(
            np.abs(jstats[k]).max(), 0.1), k


@pytest.fixture(scope="module", params=sorted(CASES))
def steps(request, tmp_path_factory):
    """(case, every rank's result, the one-process step's, the Flax trees
    before and after it, the JAX step's)."""
    name = request.param
    folder = str(tmp_path_factory.mktemp(name))
    _, make_jax, _, _, shape, _ = CASES[name]
    images, labels = inputs(name)
    model, state = start(name)
    before = flax_variables(model)
    want = jax_sgd_step(make_jax(jnp.float64), before, images, labels, LR)
    np.savez(os.path.join(folder, "masks.npz"), **want[2])
    torch_gloo.run_ranks(__file__, folder, (int(np.prod(shape)), name))
    ranks = [dict(np.load(os.path.join(folder, f"rank{r}.npz")))
             for r in range(int(np.prod(shape)))]
    state, loss = make_train_step(model)(
        state, torch.from_numpy(images), torch.from_numpy(labels),
        dropout=masks_of(folder))
    one = {"loss": float(loss)}
    one.update({"sd_" + k: v.numpy() for k, v in model.state_dict().items()})
    one.update({"g_" + k: p.grad.numpy()
                for k, p in model.named_parameters()})
    return name, ranks, one, before, want


def test_ranks_end_with_equal_weights(steps):
    _, ranks, _, _, _ = steps
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        for k, v in ranks[0].items():
            assert np.array_equal(v, r[k]), k


def test_sp_step_equals_one_process_step(steps):
    name, ranks, one, _, _ = steps
    atol = CASES[name][-1]
    got = ranks[0]
    assert abs(got["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
    assert sorted(got) == sorted(one)
    for k, v in one.items():
        if k.startswith("sd_"):
            np.testing.assert_allclose(got[k], v, rtol=1e-4, atol=atol,
                                       err_msg=k)
    grads_close(got, one, GRAD_SPLIT)



def test_sp_step_equals_jax_step(steps):
    name, ranks, _, _, want = steps
    after, grads = port_trees(CASES[name][0], ranks[0])
    check_against_jax(after, grads, ranks[0]["loss"], want)


def test_shard_batch_spatial_splits_and_refuses():
    from bugcar_image_segmentation_tpu_torch.parallel import Mesh
    mesh = Mesh(rank=5, world_size=8, device=torch.device("cpu"),
                shape=(2, 4), axis_names=("data", "space"))
    x = np.arange(4 * 8 * 3).reshape(4, 8, 3)
    got = shard_batch_spatial({"x": x}, mesh)["x"].numpy()
    np.testing.assert_array_equal(got, x[2:4, 2:4])   # data 1, space 1
    with pytest.raises(ValueError, match="rank-2"):
        shard_batch_spatial(np.zeros(8), mesh)


if __name__ == "__main__":
    torch_gloo.main(worker)
