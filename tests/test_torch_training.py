"""The port's training (``training/``): the loss, train-mode BatchNorm,
ENet's train step with dropout, remat, the eval step, AdamW and the
schedules, against the JAX package's on the same numpy inputs.

The ENet step is held against the JAX step (``make_train_step``'s
arithmetic: ``value_and_grad`` of the Flax forward with
``mutable=["batch_stats"]``, then ``apply_gradients`` with
``optax.adamw``), run for three steps in float64 from the port's
``create_train_state`` tree (through the inverse bridge), with the
dropout masks JAX draws recovered through ``flax.linen.intercept_methods``
(the test runs JAX's dropout on ones and multiplies, and hands the port
the same masks).  Each port step starts from the JAX run's state before
that step (parameters, statistics, AdamW moments and count), so each
step's arithmetic is held on its own.

Why float64, and why from JAX's states: ENet's PReLUs and max pools have
kinks, and an f32 rounding that puts a value on the other side of one
moves a gradient element by its whole size.  Measured at this input, the
JAX package's own float32 gradients are up to 0.8 % (relative L2, per
leaf) from its float64 ones and the port's up to 0.4 %; and AdamW's
first update is ``sign(g) * lr`` wherever |g| >> eps, so an element whose
gradient is within that noise of 0 moves by 2 lr the other way.  Three
free-running float32 steps at lr 3e-3 then leave the float64 loss by
1.7e-4 and 1.5e-3 (JAX's float32 run) or 3.7e-4 and 1.9e-3 (the port's):
chaos, not a fault, and the free-running test below pins that loosely.

So a step is held in two parts: its gradients against JAX's, and its
AdamW update against ``optax.adamw``'s update of JAX's state by the
port's own gradients.

Tolerances (measured on the CPU, pinned with margin): loss 1e-5 relative
each step (measured <= 1.3e-6); relative L2 error of a leaf's gradient
5e-2 (measured, steps 0 / 1 / 2: 3.9e-3 / 1.8e-2 / 5.7e-6) and its median
over the leaves 2e-2 (7.3e-6 / 5.5e-3 / 3.1e-6); updated parameters
within 1e-3 lr of optax's; running statistics 1e-5 of their leaf's max
(measured <= 1.2e-6).
"""

import copy

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bugcar_image_segmentation_tpu.models.enet import ENet as JENet
from bugcar_image_segmentation_tpu.models.unet import UNet as JUNet
from bugcar_image_segmentation_tpu.training import (
    TrainState as JTrainState, make_eval_step as jeval,
    softmax_cross_entropy as jce)
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    enet_state_dict
from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
    flax_variables
from bugcar_image_segmentation_tpu_torch.models.enet import ENet
from bugcar_image_segmentation_tpu_torch.models.layers import BatchNorm
from bugcar_image_segmentation_tpu_torch.models.unet import UNet
from bugcar_image_segmentation_tpu_torch.training import (
    AdamW, create_train_state, make_eval_step, make_train_step,
    softmax_cross_entropy, warmup_constant, warmup_cosine_decay)

HW = (32, 64)
LR = 3e-3
STEPS = 3
LOSS_RTOL = 1e-5
GRAD_L2 = 5e-2
GRAD_L2_MEDIAN = 2e-2
PARAM_ATOL = 1e-3 * LR
STATS_RTOL = 1e-5
FREE_LOSS_RTOL = 1e-2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: other test workers share the host's cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree, prefix=()):
    """(path, numpy leaf) of a nested dict, depth first."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def as_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def recording_dropout(record):
    """Flax method interceptor: ``nn.Dropout(x)`` becomes ``x * m`` with
    ``m`` = the same dropout applied to ones (the mask JAX draws, scaled
    by 1 / keep), recorded under the bottleneck's name."""
    def intercept(next_fun, args, kwargs, context):
        if (isinstance(context.module, fnn.Dropout)
                and context.method_name == "__call__"):
            x = args[0]
            m = next_fun(jnp.ones_like(x), *args[1:], **kwargs)
            record[context.module.parent.name] = m
            return x * m
        return next_fun(*args, **kwargs)
    return intercept


def jax_step(model):
    """JAX's make_train_step, returning the gradients and the dropout
    masks beside the new state and the loss."""
    def step(state, images, labels, key):
        def loss_fn(params):
            masks = {}
            with fnn.intercept_methods(recording_dropout(masks)):
                logits, upd = model.apply(
                    {"params": params, "batch_stats": state.batch_stats},
                    images, train=True, rngs={"dropout": key},
                    mutable=["batch_stats"])
            return jce(logits, labels), (upd["batch_stats"], masks)

        (loss, (stats, masks)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        new = state.apply_gradients(grads=grads).replace(batch_stats=stats)
        return new, loss, grads, masks
    return jax.jit(step)


def port_grads(model):
    """The gradients of the last backward, in the Flax tree's layout."""
    twin = copy.deepcopy(model)
    twin.load_state_dict({**model.state_dict(),
                          **{k: p.grad for k, p in model.named_parameters()}})
    return flax_variables(twin)["params"]


def l2_rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-30))


def jax_state_record(state):
    adam = state.opt_state[0]
    return dict(params=as_numpy(state.params),
                stats=as_numpy(state.batch_stats), mu=as_numpy(adam.mu),
                nu=as_numpy(adam.nu), count=int(adam.count))


@pytest.fixture(scope="module")
def enet_runs():
    """The port's initial ENet tree (create_train_state, seed 0) and JAX's
    ENet (textbook path) trained STEPS steps from it in float64: the
    state before each step, its loss, gradients and masks, and the eval
    logits after the last; the batch has ignore labels."""
    model = ENet(15)
    create_train_state(model, (1,) + HW + (3,), device="cpu")
    tree = flax_variables(model)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2,) + HW + (3,)).astype(np.float32)
    labels = rng.integers(0, 15, (2,) + HW).astype(np.int32)
    labels[0, :6] = 255
    with jax.enable_x64(True):
        jm = JENet(num_classes=15, dtype=jnp.float64, fast=False)
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        state = JTrainState.create(apply_fn=jm.apply,
                                   params=cast(tree["params"]),
                                   batch_stats=cast(tree["batch_stats"]),
                                   tx=optax.adamw(LR))
        step = jax_step(jm)
        x64 = jnp.asarray(images, jnp.float64)
        steps = []
        for i in range(STEPS):
            before = jax_state_record(state)
            state, loss, grads, masks = step(state, x64, labels,
                                             jax.random.PRNGKey(7 + i))
            steps.append(dict(before=before, loss=float(loss),
                              grads=as_numpy(grads),
                              masks={k: np.asarray(m, np.float32)
                                     for k, m in masks.items()}))
        after = jax_state_record(state)
        logits = np.asarray(jax.jit(jeval(jm))(state, x64))
    return tree, images, labels, dict(steps=steps, after=after,
                                      logits=logits)


def masks_of(run_step):
    """JAX's (N, 1, 1, C) masks as the port's name → (N, C)."""
    return {k: torch.from_numpy(m[:, 0, 0, :].copy())
            for k, m in run_step["masks"].items()}


def port_enet(remat=False):
    model = ENet(15)
    state = create_train_state(model, (1,) + HW + (3,), learning_rate=LR,
                               device="cpu")
    return model, state, make_train_step(model, remat=remat)


def load_jax_state(model, state, rec):
    """Put a JAX state record (parameters, statistics, AdamW moments and
    count) into the port's model and train state."""
    model.load_state_dict(enet_state_dict(
        {"params": rec["params"], "batch_stats": rec["stats"]}))
    for name in ("mu", "nu"):
        moments = enet_state_dict({"params": rec[name]})
        for k, t in getattr(state.opt_state, name).items():
            t.copy_(moments[k])
    state.opt_state.count = state.step = rec["count"]


@pytest.fixture(scope="module")
def port_steps(enet_runs):
    """Step i of the port from JAX's state before step i: the loss, the
    gradients and the state after, per step; the model and state after
    the last step are kept for the eval test (their folds stale)."""
    _, images, labels, runs = enet_runs
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    model, state, step = port_enet()
    out = []
    for s in runs["steps"]:
        load_jax_state(model, state, s["before"])
        state, loss = step(state, x, y, dropout=masks_of(s))
        tree = flax_variables(model)
        out.append(dict(loss=float(loss), grads=port_grads(model),
                        params=tree["params"], stats=tree["batch_stats"]))
    return out, model, state


def jax_after(runs, i):
    return runs["steps"][i + 1]["before"] if i + 1 < STEPS else runs["after"]


def optax_update(before, grads):
    """``optax.adamw(LR)``'s update of a JAX state record by ``grads``, in
    float64."""
    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        tx = optax.adamw(LR)

        @jax.jit
        def update(params, mu, nu, count, grads):
            opt = tx.init(params)
            opt = (opt[0]._replace(count=count, mu=mu, nu=nu),) + tuple(
                opt[1:])
            upd, _ = tx.update(grads, opt, params)
            return optax.apply_updates(params, upd)

        return as_numpy(update(
            cast(before["params"]), cast(before["mu"]), cast(before["nu"]),
            jnp.asarray(before["count"], jnp.int32), cast(grads)))


def test_dropout_masks_recovered(enet_runs):
    """27 bottlenecks, (N, 1, 1, C) masks of 0 and 1 / (1 - rate), rate
    0.01 in stage 1 and 0.1 after, as the port's dropout_masks draws."""
    _, _, _, runs = enet_runs
    masks = runs["steps"][0]["masks"]
    names = [n for n, _ in ENet(15).bottlenecks()]
    assert sorted(masks) == sorted(names) and len(names) == 27
    drawn = ENet(15).dropout_masks(torch.Generator().manual_seed(0), 2)
    for name, m in masks.items():
        keep = 0.99 if name.startswith("b1_") else 0.9
        assert set(np.unique(m).tolist()) <= {0.0, np.float32(1 / keep)}
        d = drawn[name].numpy()
        assert d.shape == (2, m.shape[-1])
        assert set(np.unique(d).tolist()) <= {0.0, np.float32(1 / keep)}


@pytest.mark.parametrize("step", range(STEPS))
def test_enet_step_matches_jax(enet_runs, port_steps, step):
    """Step ``step`` from JAX's state before it: loss, gradients, the
    AdamW update (at count ``step``) of the port's gradients, and the
    running statistics."""
    _, _, _, runs = enet_runs
    got = port_steps[0][step]
    want = runs["steps"][step]
    assert abs(got["loss"] - want["loss"]) <= LOSS_RTOL * abs(want["loss"])
    grads = dict(leaves(want["grads"]))
    assert sorted(dict(leaves(got["grads"]))) == sorted(grads)
    errs = [(l2_rel(g, grads[k]), k) for k, g in leaves(got["grads"])]
    assert max(errs)[0] <= GRAD_L2, max(errs)
    assert np.median([e for e, _ in errs]) <= GRAD_L2_MEDIAN
    params = dict(leaves(optax_update(want["before"], got["grads"])))
    for k, p in leaves(got["params"]):
        assert np.abs(p - params[k]).max() <= PARAM_ATOL, k
    after = jax_after(runs, step)
    stats = dict(leaves(after["stats"]))
    assert len(stats) == len(dict(leaves(got["stats"])))
    for k, st in leaves(got["stats"]):
        assert np.abs(st - stats[k]).max() <= (
            STATS_RTOL * np.abs(stats[k]).max()), k


def test_enet_eval_after_training_matches_jax(enet_runs, port_steps):
    """make_eval_step refolds the BatchNorms from the trained weights (the
    step left the folds stale): its logits are JAX's make_eval_step's
    after the same steps."""
    _, images, _, runs = enet_runs
    _, model, state = port_steps
    want = runs["logits"]
    got = make_eval_step(model)(state, torch.from_numpy(images)).numpy()
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    assert not model.training


def test_enet_free_running_steps(enet_runs):
    """The port's own three steps from the initial tree (masks shared):
    the first loss is JAX's, the later ones drift as JAX's own float32 run
    drifts from its float64 one (module docstring)."""
    tree, images, labels, runs = enet_runs
    model, state, step = port_enet()
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    for i, s in enumerate(runs["steps"]):
        state, loss = step(state, x, y, dropout=masks_of(s))
        tol = LOSS_RTOL if i == 0 else FREE_LOSS_RTOL
        assert abs(float(loss) - s["loss"]) <= tol * s["loss"], i
    assert state.step == STEPS and state.opt_state.count == STEPS


def test_remat_step_equals_plain(enet_runs):
    """torch.utils.checkpoint recomputes the forward with the same masks
    and statistics: loss, parameters and running statistics are the plain
    step's bit for bit."""
    _, images, labels, runs = enet_runs
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    out = []
    for remat in (False, True):
        model, state, step = port_enet(remat=remat)
        for s in runs["steps"][:2]:
            state, loss = step(state, x, y, dropout=masks_of(s))
        out.append((float(loss), model.state_dict()))
    assert out[0][0] == out[1][0]
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


def test_enet_step_draws_masks_from_rng():
    """Without given masks the step draws them from ``rng``: the same
    generator state gives the same step, another gives another."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(2, 16, 32, 3)).astype(np.float32))
    y = torch.from_numpy(rng.integers(0, 15, (2, 16, 32)))
    losses = []
    for seed in (1, 1, 2):
        model = ENet(15)
        state = create_train_state(model, (1, 16, 32, 3), device="cpu")
        state, loss = make_train_step(model)(
            state, x, y, torch.Generator().manual_seed(seed))
        losses.append(float(loss))
    assert losses[0] == losses[1] != losses[2]
    with pytest.raises(ValueError, match="dropout"):
        make_train_step(model)(state, x, y)


CE_CASES = ["plain", "ignore", "weights", "all_ignored", "out_of_range"]


@pytest.mark.parametrize("case", CE_CASES)
def test_cross_entropy_matches_jax(case):
    rng = np.random.default_rng(CE_CASES.index(case))
    logits = rng.normal(size=(2, 5, 7, 6)).astype(np.float32) * 3
    labels = rng.integers(0, 6, (2, 5, 7)).astype(np.int32)
    weights = None
    if case == "ignore":
        labels[0, :3] = 255
    elif case == "weights":
        weights = rng.uniform(0.2, 3.0, 6).astype(np.float32)
        labels[1, 1] = 255
    elif case == "all_ignored":
        labels[:] = 255
    elif case == "out_of_range":
        labels[0, 0, :4] = 9
    want = float(jce(jnp.asarray(logits), jnp.asarray(labels),
                     None if weights is None else jnp.asarray(weights)))
    got = float(softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels),
        None if weights is None else torch.from_numpy(weights)))
    assert abs(got - want) <= 1e-6 * max(abs(want), 1e-30)
    # the gather formulation, in float64
    valid = (labels != 255) & (labels < 6)
    lf = logits.astype(np.float64)
    lse = np.log(np.exp(lf).sum(-1))
    picked = np.take_along_axis(lf, np.where(valid, labels, 0)[..., None],
                                -1)[..., 0]
    w = valid * (1.0 if weights is None
                 else weights[np.where(valid, labels, 0)])
    ref = ((lse - picked) * w).sum() / max(w.sum(), 1.0)
    assert abs(got - ref) <= 1e-6 * max(abs(ref), 1e-30)


@pytest.mark.parametrize("momentum", [0.9, 0.99])
def test_batchnorm_train_step_matches_flax(momentum):
    """Outputs, gradients to x / scale / bias, and the new running mean and
    BIASED variance (``m * ra + (1 - m) * batch``), over the last axis."""
    rng = np.random.default_rng(int(momentum * 100))
    x = (rng.normal(size=(2, 6, 10, 12)) * 3 + 1).astype(np.float32)
    gy = rng.normal(size=x.shape).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    bias = rng.uniform(-0.5, 0.5, 12).astype(np.float32)
    mean0 = rng.uniform(-0.2, 0.2, 12).astype(np.float32)
    var0 = rng.uniform(0.5, 1.5, 12).astype(np.float32)
    bn = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=1e-3, dtype=jnp.float32)
    stats = {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}

    def f(p, x):
        y, upd = bn.apply({"params": p, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
        return jnp.sum(y * gy), (y, upd["batch_stats"])

    (_, (y, new)), (gp, gx) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(
            {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}, x)
    m = BatchNorm(12, 1e-3, momentum).train()
    with torch.no_grad():
        for t, v in ((m.scale, scale), (m.bias, bias), (m.mean, mean0),
                     (m.var, var0)):
            t.copy_(torch.from_numpy(v))
    xt = torch.from_numpy(x).requires_grad_()
    yt = m(xt)
    (yt * torch.from_numpy(gy)).sum().backward()
    mean, var = m.running_update()

    def close(a, b, rtol=2e-6):
        b = np.asarray(b)
        assert np.abs(np.asarray(a) - b).max() <= rtol * np.abs(b).max()

    close(yt.detach(), y)
    close(xt.grad, gx)
    close(m.scale.grad, gp["scale"])
    close(m.bias.grad, gp["bias"])
    close(mean, new["mean"])
    close(var, new["var"])
    # the forward left the running statistics alone
    assert torch.equal(m.mean, torch.from_numpy(mean0))


def test_small_unet_learns_synthetic_task():
    """tests/test_io_training.py's learning check on the port: a small UNet
    masters a per-pixel colour → class rule (> 0.9 accuracy after 120
    updates), through conv, BatchNorm, transposed-conv and skip paths."""
    model = UNet(num_classes=15, widths=(8, 16), bottleneck_width=32)
    state = create_train_state(model, (1, 16, 32, 3), learning_rate=5e-3,
                               device="cpu")
    step = make_train_step(model)

    def batch(i):
        r = np.random.default_rng(i)
        imgs = r.normal(size=(8, 16, 32, 3)).astype(np.float32)
        labels = (imgs[..., 0] > imgs[..., 2]).astype(np.int64) * 2
        return torch.from_numpy(imgs), torch.from_numpy(labels)

    for i in range(120):
        state, _ = step(state, *batch(i))
    images, labels = batch(9999)
    pred = make_eval_step(model)(state, images).argmax(-1)
    acc = float((pred == labels).float().mean())
    assert acc > 0.9, f"accuracy {acc}"


def test_create_train_state_matches_flax_init_statistics():
    """Flax's initial values: unit BatchNorm scales, zero biases, PReLU
    0.25, running mean 0 / var 1, LeCun-normal kernels (std sqrt(1 /
    fan_in), truncated at 2 sigma) -- the JAX tree's leaves, in law."""
    jm = JUNet(num_classes=15, widths=(8, 16), bottleneck_width=32,
               dtype=jnp.float32)
    jtree = as_numpy(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                      jnp.zeros((1, 16, 32, 3)))["params"])
    model = UNet(num_classes=15, widths=(8, 16), bottleneck_width=32)
    state = create_train_state(model, (1, 16, 32, 3), device="cpu", seed=4)
    got = dict(leaves(flax_variables(model)["params"]))
    for k, want in leaves(jtree):
        g = got[k]
        assert g.shape == want.shape, k
        if k[-1] == "kernel":
            fan_in = int(np.prod(want.shape[:-1]))
            bound = 2 / 0.87962566103423978 / np.sqrt(fan_in)
            assert np.abs(g).max() <= bound * (1 + 1e-6), k
            if g.size >= 1000:
                assert abs(g.std() * np.sqrt(fan_in) - 1) < 0.1, k
        else:
            np.testing.assert_array_equal(g, want, err_msg=str(k))
    assert state.step == 0 and set(state.batch_stats) == {
        k for k in model.state_dict() if k.endswith((".mean", ".var"))}
    with pytest.raises(ValueError):
        create_train_state(UNet(num_classes=3, widths=(8,),
                                bottleneck_width=8), (1, 13, 32, 3),
                           device="cpu")


def test_adamw_step_matches_optax():
    """Two AdamW updates (optax's defaults: weight decay 1e-4 on every
    leaf) under a warmup schedule, from gradients given."""
    rng = np.random.default_rng(5)
    params = {"a": rng.normal(size=(4, 3)).astype(np.float32),
              "b": rng.normal(size=(7,)).astype(np.float32)}
    grads = [{k: rng.normal(size=v.shape).astype(np.float32) * 1e-2
              for k, v in params.items()} for _ in range(2)]
    sched = optax.join_schedules(
        [optax.linear_schedule(0.0, 1e-2, 2), optax.constant_schedule(1e-2)],
        [2])
    tx = optax.adamw(sched)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    opt = tx.init(jp)
    ours = AdamW(warmup_constant(1e-2, 2))
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = ours.init(tp)
    for g in grads:
        upd, opt = tx.update(jax.tree_util.tree_map(jnp.asarray, g), opt, jp)
        jp = optax.apply_updates(jp, upd)
        for k, t in tp.items():
            t.grad = torch.from_numpy(g[k])
        ours.step(tp, st)
    for k in params:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-7)
    assert st.count == 2


@pytest.mark.parametrize("kind", ["warmup_constant", "cosine"])
def test_schedules_match_optax(kind):
    """scripts/train.py's two schedules, counted as optax counts them."""
    if kind == "cosine":
        want = optax.warmup_cosine_decay_schedule(0.0, 3e-4, 3, 10)
        got = warmup_cosine_decay(3e-4, 3, 10)
    else:
        want = optax.join_schedules(
            [optax.linear_schedule(0.0, 3e-4, 4),
             optax.constant_schedule(3e-4)], [4])
        got = warmup_constant(3e-4, 4)
    for count in range(12):
        assert abs(got(count) - float(want(count))) <= 1e-6 * 3e-4, count
    assert got(0) == 0.0
