"""The port's data-parallel train step (``parallel/mesh.py`` +
``make_train_step(..., mesh=)``) in two gloo processes on the CPU, against
the single-process step over the whole batch and the JAX package's
sharded step (tests/test_io_training.py:242's, on a 2-device mesh).

ENet at 16x32, a global batch of 4 split 2 + 2, class weights, and the
ignore labels packed into rank 1's shard, so that the shards' loss
denominators differ: averaging per-rank mean losses would be wrong here.
The dropout masks are drawn for the global batch (JAX's, recovered as in
tests/test_torch_training.py) and each rank takes its rows.  Rank 1
starts from other weights, which ``replicate`` overwrites with rank 0's.

Tolerances (measured on the CPU, pinned with margin): loss 1e-5 relative
(measured: equal to the single process's, 7.5e-7 from JAX's); the summed
gradients per leaf within 1e-4 relative L2 of the single process's
(measured 2.7e-5: the sums are split) and 5e-2 of JAX's float64 sharded
step (measured 2.6e-5; the margin is for ENet's kinks, see
tests/test_torch_training.py); running statistics 1e-5 of max(their
leaf's max, 0.1) (measured 1.9e-6 / 1.2e-6); both ranks' weights equal
bit for bit.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

if __name__ != "__main__":
    import flax.linen as fnn
    import jax
    import jax.numpy as jnp
    import optax

    from bugcar_image_segmentation_tpu.models.enet import ENet as JENet
    from bugcar_image_segmentation_tpu.parallel import (make_mesh as jmesh,
                                                        replicate as jrep,
                                                        shard_batch as jshard)
    from bugcar_image_segmentation_tpu.training import (
        TrainState as JTrainState, softmax_cross_entropy as jce)
    from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
        flax_variables

from bugcar_image_segmentation_tpu_torch.models.enet import ENet
from bugcar_image_segmentation_tpu_torch.parallel import (make_mesh,
                                                          replicate,
                                                          shard_batch)
from bugcar_image_segmentation_tpu_torch.training import (
    create_train_state, make_train_step)

HW = (16, 32)
GLOBAL = 4
WORLD = 2
LR = 3e-3
PROC_TIMEOUT_S = 240


def worker(rank: int, port: int, folder: str) -> None:
    """One rank: replicate rank 0's weights, take one DP step on this
    rank's shard, save loss, weights and summed gradients."""
    torch.set_num_threads(1)
    data = np.load(os.path.join(folder, "inputs.npz"))
    mesh = make_mesh(WORLD, device="cpu",
                     init_method=f"tcp://localhost:{port}", rank=rank,
                     timeout_s=PROC_TIMEOUT_S / 2)
    try:
        model = ENet(15)
        state = create_train_state(model, (1,) + HW + (3,),
                                   learning_rate=LR, device="cpu", seed=rank)
        model.load_state_dict({k[3:]: torch.from_numpy(data[k])
                               for k in data.files if k.startswith("sd_")}
                              if rank == 0 else model.state_dict())
        replicate(state, mesh)
        x, y = shard_batch((data["images"], data["labels"]), mesh)
        masks = {k[5:]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith("mask_")}
        step = make_train_step(model, class_weights=data["cw"], mesh=mesh)
        state, loss = step(state, x, y, dropout=masks)
        out = {"loss": float(loss)}
        out.update({"sd_" + k: v.numpy() for k, v in
                    model.state_dict().items()})
        out.update({"g_" + k: p.grad.numpy() for k, p in
                    model.named_parameters()})
        np.savez(os.path.join(folder, f"rank{rank}.npz"), **out)
    finally:
        mesh.close()


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def l2_rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-30))


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


def jax_sharded_step(tree, images, labels, cw):
    """JAX's train step (make_train_step's arithmetic, gradients and masks
    returned too) jitted over a 2-device mesh with the batch sharded, in
    float64."""
    with jax.enable_x64(True):
        jm = JENet(num_classes=15, dtype=jnp.float64, fast=False)
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        state = JTrainState.create(apply_fn=jm.apply,
                                   params=cast(tree["params"]),
                                   batch_stats=cast(tree["batch_stats"]),
                                   tx=optax.adamw(LR))
        weights = jnp.asarray(cw, jnp.float64)

        def step(state, images, labels, key):
            def loss_fn(params):
                masks = {}
                with fnn.intercept_methods(recording_dropout(masks)):
                    logits, upd = jm.apply(
                        {"params": params, "batch_stats": state.batch_stats},
                        images, train=True, rngs={"dropout": key},
                        mutable=["batch_stats"])
                return jce(logits, labels, weights), (upd["batch_stats"],
                                                      masks)

            (loss, (stats, masks)), grads = jax.value_and_grad(
                loss_fn, has_aux=True)(state.params)
            new = state.apply_gradients(grads=grads).replace(
                batch_stats=stats)
            return new, loss, grads, masks

        mesh = jmesh(WORLD)
        state = jrep(state, mesh)
        x, y = jshard((jnp.asarray(images, jnp.float64),
                       jnp.asarray(labels)), mesh)
        new, loss, grads, masks = jax.jit(step)(state, x, y,
                                                jax.random.PRNGKey(3))
        return dict(loss=float(loss),
                    grads=jax.tree_util.tree_map(np.asarray, grads),
                    stats=jax.tree_util.tree_map(np.asarray,
                                                 new.batch_stats),
                    masks={k: np.asarray(m, np.float32)[:, 0, 0, :]
                           for k, m in masks.items()})


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("dp"))
    rng = np.random.default_rng(11)
    images = rng.normal(size=(GLOBAL,) + HW + (3,)).astype(np.float32)
    labels = rng.integers(0, 15, (GLOBAL,) + HW).astype(np.int32)
    labels[2:] = np.where(rng.uniform(size=labels[2:].shape) < 0.6, 255,
                          labels[2:])          # rank 1's shard
    cw = rng.uniform(0.3, 2.0, 15).astype(np.float32)
    model = ENet(15)
    create_train_state(model, (1,) + HW + (3,), device="cpu", seed=0)
    tree = flax_variables(model)
    want = jax_sharded_step(tree, images, labels, cw)
    np.savez(os.path.join(folder, "inputs.npz"), images=images,
             labels=labels, cw=cw,
             **{"sd_" + k: v.numpy() for k, v in model.state_dict().items()},
             **{"mask_" + k: v for k, v in want["masks"].items()})
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + sys.path))
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__),
                               str(rank), str(port), folder], env=env,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for rank in range(WORLD)]
    errors = []
    for p in procs:
        try:
            _, err = p.communicate(timeout=PROC_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            p.kill()
            _, err = p.communicate()
            errors.append("timed out: " + err[-2000:])
            continue
        if p.returncode:
            errors.append(err[-3000:])
    assert not errors, errors
    ranks = [dict(np.load(os.path.join(folder, f"rank{r}.npz")))
             for r in range(WORLD)]
    # the single-process step over the whole batch, same masks
    single_model = ENet(15)
    single = create_train_state(single_model, (1,) + HW + (3,),
                                learning_rate=LR, device="cpu")
    single_model.load_state_dict(model.state_dict())
    step = make_train_step(single_model, class_weights=cw)
    masks = {k: torch.from_numpy(v) for k, v in want["masks"].items()}
    single, loss = step(single, torch.from_numpy(images),
                        torch.from_numpy(labels), dropout=masks)
    one = {"loss": float(loss)}
    one.update({"sd_" + k: v.numpy() for k, v in
                single_model.state_dict().items()})
    one.update({"g_" + k: p.grad.numpy() for k, p in
                single_model.named_parameters()})
    return ranks, one, want


def test_ranks_end_with_equal_weights(runs):
    ranks, _, _ = runs
    for k, v in ranks[0].items():
        if k.startswith(("sd_", "g_")):
            assert np.array_equal(v, ranks[1][k]), k
    assert ranks[0]["loss"] == ranks[1]["loss"]


def test_dp_step_equals_single_process_step(runs):
    ranks, one, _ = runs
    dp = ranks[0]
    assert abs(dp["loss"] - one["loss"]) <= 1e-5 * one["loss"]
    for k, g in one.items():
        if k.startswith("g_"):
            assert l2_rel(dp[k], g) <= 1e-4, k
        elif k.startswith("sd_") and k.endswith((".mean", ".var")):
            assert np.abs(dp[k] - g).max() <= 1e-5 * max(
                np.abs(g).max(), 0.1), k


def test_dp_step_equals_jax_sharded_step(runs):
    ranks, _, want = runs
    dp = ranks[0]
    assert abs(dp["loss"] - want["loss"]) <= 1e-5 * want["loss"]
    model = ENet(15)
    model.load_state_dict({k[3:]: torch.from_numpy(v) for k, v in dp.items()
                           if k.startswith("sd_")})
    stats = dict(leaves(flax_variables(model)["batch_stats"]))
    for k, s in leaves(want["stats"]):
        assert np.abs(stats[k] - s).max() <= 1e-5 * max(np.abs(s).max(),
                                                         0.1), k
    twin = ENet(15)
    twin.load_state_dict({**model.state_dict(), **{
        k[2:]: torch.from_numpy(v) for k, v in dp.items()
        if k.startswith("g_")}})
    grads = dict(leaves(flax_variables(twin)["params"]))
    for k, g in leaves(want["grads"]):
        assert l2_rel(grads[k], g) <= 5e-2, k


def test_shard_batch_and_make_mesh_refuse_bad_input():
    from bugcar_image_segmentation_tpu_torch.parallel import Mesh
    mesh = Mesh(rank=1, world_size=2, device=torch.device("cpu"))
    x = np.arange(12).reshape(4, 3)
    got = shard_batch({"x": x, "t": (torch.arange(4),)}, mesh)
    np.testing.assert_array_equal(got["x"].numpy(), x[2:])
    assert got["t"][0].tolist() == [2, 3]
    with pytest.raises(ValueError, match="divide"):
        shard_batch(np.zeros((3, 2)), mesh)
    with pytest.raises(ValueError, match="device"):
        make_mesh(1, device="tpu")


if __name__ == "__main__":
    worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
