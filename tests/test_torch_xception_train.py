"""Xception-65 DeepLab in train mode: the port against the JAX package's
``Xception65DeepLab(train=True)`` on the same seeded tree (two middle
blocks, 2x64x64 inputs; the port in float32, the JAX reference in
float64: its own float32 train-mode logits sit 2e-4 of their max from
its float64 ones, as two images' statistics at 4x4 leave BatchNorm little
to average).

The port's ``_fs``, ``pw_int8`` and ``head_upsample="quarter"`` models
must compute the Flax module's train-mode function: BatchNorm from the
batch, full-resolution logits, no fused kernel (which folds the running
statistics and has no backward) and no int8 pointwise.  Then one
``make_train_step`` of the ``_fs`` model against the JAX step (float64,
as tests/test_torch_training_models.py holds the other models, with its
tolerances), and the eval step after it, whose kernel arguments and int8
weights must come from the new weights and not from the ones an earlier
eval forward cached.  The fused kernel's refusal of inputs that require
grad is held here on CPU tensors through the wrapper's device seam
(``ops/cuda/sepconv._CARD``); tests/test_torch_cuda.py holds it on the
card.

Tolerances: train-mode logits 2e-4 of their max (measured 7.2e-5);
loss, gradients, update and statistics as tests/test_torch_training_
models.py (loss 1e-5 relative; gradient L2 5e-2, or a norm under 1e-6 of
the largest for a leaf JAX gives under 1e-8 of it; update 1e-3 lr;
statistics 5e-5 of max(leaf max, 0.1)); eval logits 1e-4 of their max
(float), and for ``pw_int8`` the JAX package's int8 budget, 0.02 of
max|y| (tests/test_torch_xception_int8.py).

A float64 model computes in float64, as the card-against-CPU check of
the Xception step takes a float64 step for its reference: BatchNorm
(train and eval) against Flax's ``nn.BatchNorm`` in float64, which
promotes to the wider of the input's dtype and f32; the ASPP-to-decoder
upsample against ``jax.image.resize`` in float64; the loss against
numpy's float64.  Each within 1e-12 of its max, where an f32 computation
sits ~1e-7 away.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bugcar_image_segmentation_tpu.models.xception import \
    Xception65DeepLab as JX
from bugcar_image_segmentation_tpu.training import (
    TrainState as JTrainState, softmax_cross_entropy as jce)
from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
    flax_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_xception import \
    xception_state_dict
from bugcar_image_segmentation_tpu_torch.models.layers import BatchNorm
from bugcar_image_segmentation_tpu_torch.models.xception import \
    Xception65DeepLab
from bugcar_image_segmentation_tpu_torch.ops.cuda import sepconv as sc
from bugcar_image_segmentation_tpu_torch.ops.resize import upsample_bilinear
from bugcar_image_segmentation_tpu_torch.training import (
    create_train_state, make_eval_step, make_train_step,
    softmax_cross_entropy)

MIDDLE = 2
HW = (64, 64)
LR = 3e-3
TRAIN_RTOL = 2e-4
LOGIT_RTOL = 1e-4
GRAD_L2 = 5e-2
ZERO_GRAD = 1e-6
STATS_RTOL = 5e-5
INT8_REL = 0.02
# the port's constructor flags and the JAX module's, by variant
VARIANTS = {"fs": dict(fused_sepconv=True), "int8": dict(pw_int8=True),
            "quarter": dict(head_upsample="quarter")}
F64_RTOL = 1e-12


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


def cast(tree, dtype):
    return jax.tree_util.tree_map(lambda a: jnp.asarray(a, dtype), tree)


@pytest.fixture(scope="module")
def data():
    """The port's initial tree (``create_train_state``, seed 2), the
    inputs and labels."""
    model = Xception65DeepLab(middle_blocks=MIDDLE)
    create_train_state(model, (1,) + HW + (3,), device="cpu", seed=2)
    rng = np.random.default_rng(1)
    images = rng.normal(size=(2,) + HW + (3,)).astype(np.float32)
    labels = rng.integers(0, 15, (2,) + HW).astype(np.int32)
    labels[1, -5:] = 255
    return flax_variables(model), images, labels


def port_model(tree, **kw):
    m = Xception65DeepLab(middle_blocks=MIDDLE, **kw)
    m.load_state_dict(xception_state_dict(tree))
    return m


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_train_forward_matches_jax(data, variant):
    """A train-mode forward of the ``_fs``, int8 and quarter-head models is
    the Flax module's ``train=True`` forward (and the new running
    statistics are its ``batch_stats``)."""
    tree, images, _ = data
    kw = VARIANTS[variant]
    with jax.enable_x64(True):
        jm = JX(middle_blocks=MIDDLE, dtype=jnp.float64, **kw)
        want, upd = jm.apply(cast(tree, jnp.float64),
                             jnp.asarray(images, jnp.float64), train=True,
                             mutable=["batch_stats"])
        want = np.asarray(want)
        stats = dict(leaves(jax.tree_util.tree_map(np.asarray,
                                                   upd["batch_stats"])))
    m = port_model(tree, **kw)
    with torch.no_grad():
        m.eval()(torch.from_numpy(images))      # caches folds / int8 weights
        got = m.train()(torch.from_numpy(images)).numpy()
    assert got.shape == want.shape == (2,) + HW + (15,)
    err = np.abs(got - want).max()
    assert err <= TRAIN_RTOL * np.abs(want).max(), (variant, err)
    for name, bn in m.named_modules():
        if isinstance(bn, BatchNorm):
            mean, var = bn.running_update()
            for leaf, v in (("mean", mean), ("var", var)):
                w = stats[tuple(name.split(".")) + (leaf,)]
                assert np.abs(v.numpy() - w).max() <= (
                    STATS_RTOL * max(np.abs(w).max(), 0.1)), (name, leaf)


def jax_step(jm):
    """make_train_step's arithmetic, returning the gradients too."""
    def step(state, images, labels):
        def loss_fn(params):
            logits, upd = jm.apply(
                {"params": params, "batch_stats": state.batch_stats},
                images, train=True, mutable=["batch_stats"])
            return jce(logits, labels), upd["batch_stats"]

        (loss, stats), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        new = state.apply_gradients(grads=grads).replace(batch_stats=stats)
        return new, loss, grads
    return step


@pytest.fixture(scope="module")
def step_pair(data):
    """One train step of the port's ``_fs`` model (after an eval forward
    that cached its kernel arguments) and of the JAX module, in f64."""
    tree, images, labels = data
    model = Xception65DeepLab(middle_blocks=MIDDLE, fused_sepconv=True)
    state = create_train_state(model, (1,) + HW + (3,), learning_rate=LR,
                               device="cpu", seed=2)
    model.load_state_dict(xception_state_dict(tree))
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    with torch.no_grad():
        model.eval()(x)
    cached = [m for m in model.sepconvs() if m._kernel_args is not None]
    assert len(cached) == 7 + 3 * MIDDLE        # the kernel's sites
    state, loss = make_train_step(model)(state, x, y)
    grads = port_model(tree)
    grads.load_state_dict({**model.state_dict(), **{
        k: p.grad for k, p in model.named_parameters()}})
    after = flax_variables(model)
    got = dict(loss=float(loss), grads=flax_variables(grads)["params"],
               params=after["params"], stats=after["batch_stats"],
               logits=make_eval_step(model)(state, x).numpy(), model=model)
    with jax.enable_x64(True):
        jm = JX(middle_blocks=MIDDLE, dtype=jnp.float64)
        js = JTrainState.create(apply_fn=jm.apply,
                                params=cast(tree["params"], jnp.float64),
                                batch_stats=cast(tree["batch_stats"],
                                                 jnp.float64),
                                tx=optax.adamw(LR))
        js, jloss, jgrads = jax.jit(jax_step(jm))(
            js, jnp.asarray(images, jnp.float64), labels)
        want = dict(loss=float(jloss), grads=jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64), jgrads),
            stats=jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                         js.batch_stats))
    return tree, got, want


def test_train_step_matches_jax(step_pair):
    """Loss, every gradient leaf, the AdamW update and the running
    statistics of the ``_fs`` model's step against the JAX step."""
    tree, got, want = step_pair
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * want["loss"]
    grads = dict(leaves(want["grads"]))
    assert sorted(grads) == sorted(dict(leaves(got["grads"])))
    top = max(np.linalg.norm(g) for g in grads.values())
    for k, g in leaves(got["grads"]):
        if np.linalg.norm(grads[k]) < 1e-8 * top:      # zero, exactly
            assert np.linalg.norm(g) <= ZERO_GRAD * top, k
        else:
            assert l2_rel(g, grads[k]) <= GRAD_L2, k
    with jax.enable_x64(True):
        tx = optax.adamw(LR)

        @jax.jit
        def update(params, grads):
            upd, _ = tx.update(grads, tx.init(params), params)
            return optax.apply_updates(params, upd)

        new = dict(leaves(jax.tree_util.tree_map(np.asarray, update(
            cast(tree["params"], jnp.float64),
            cast(got["grads"], jnp.float64)))))
    for k, p in leaves(got["params"]):
        assert np.abs(p - new[k]).max() <= 1e-3 * LR, k
    stats = dict(leaves(want["stats"]))
    assert sorted(stats) == sorted(dict(leaves(got["stats"])))
    for k, s in leaves(got["stats"]):
        assert np.abs(s - stats[k]).max() <= (
            STATS_RTOL * max(np.abs(stats[k]).max(), 0.1)), k


@pytest.mark.parametrize("variant", ["fs", "int8"])
def test_eval_after_step_serves_the_new_weights(step_pair, data, variant):
    """The eval step after training serves the trained weights: ``_fs``
    refolds its kernel arguments and ``pw_int8`` requantizes, where an
    eval forward before the step had cached them from the old weights.
    The int8 model is updated in place, as AdamW updates."""
    _, got, _ = step_pair
    _, images, _ = data
    x = torch.from_numpy(images)
    if variant == "fs":
        model, logits = got["model"], got["logits"]
    else:
        model = port_model(data[0], pw_int8=True)
        with torch.no_grad():
            model.eval()(x)
            for k, p in model.state_dict().items():
                p.copy_(got["model"].state_dict()[k])
        logits = make_eval_step(model)(SimpleNamespace(model=model),
                                       x).numpy()
    trained = flax_variables(got["model"])
    jm = JX(middle_blocks=MIDDLE, dtype=jnp.float32, **VARIANTS[variant])
    want = np.asarray(jax.jit(lambda v, a: jm.apply(v, a, train=False))(
        cast(trained, jnp.float32), jnp.asarray(images)))
    err = np.abs(logits - want).max()
    budget = LOGIT_RTOL if variant == "fs" else INT8_REL
    assert err <= budget * np.abs(want).max(), (variant, err)


@pytest.mark.parametrize("which", ["x", "wpw"])
def test_kernel_refuses_inputs_that_require_grad(monkeypatch, which):
    """The kernel has no backward: a launch whose input or weights require
    grad raises before marshalling, as the attention kernels' do."""
    monkeypatch.setattr(sc, "_CARD", "cpu")
    rng = np.random.default_rng(0)
    c, f = 32, 16
    x = torch.as_tensor(rng.standard_normal((1, 8, 8, c)), dtype=torch.float32)
    args = [torch.as_tensor(a, dtype=torch.float32) for a in (
        rng.standard_normal((3, 3, 1, c)), np.ones(c), np.zeros(c),
        rng.standard_normal((c, f)), np.ones(f), np.zeros(f))]
    sc.check_args(x, *args)                     # the same, without grad
    if which == "x":
        x.requires_grad_()
    else:
        args[3].requires_grad_()
    with pytest.raises(ValueError, match="no backward"):
        sc.check_args(x, *args)


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_batchnorm_float64_computes_in_float64(train):
    """A float64 input is normalised in float64 (and the running update
    too), as Flax's BatchNorm computes it."""
    rng = np.random.default_rng(3)
    x = rng.normal(2.0, 0.5, (2, 5, 7, 6))       # a mean that cancels
    scale, bias = rng.normal(1.0, 0.1, 6), rng.normal(0.0, 0.1, 6)
    mean, var = rng.normal(2.0, 0.1, 6), rng.uniform(0.2, 0.4, 6)
    bn = BatchNorm(6, 1e-3).double()
    with torch.no_grad():
        for t, v in ((bn.scale, scale), (bn.bias, bias), (bn.mean, mean),
                     (bn.var, var)):
            t.copy_(torch.from_numpy(v))
    bn.train(train)
    with torch.no_grad():
        got = bn(torch.from_numpy(x))
    with jax.enable_x64(True):
        jbn = fnn.BatchNorm(use_running_average=not train, momentum=0.99,
                            epsilon=1e-3, param_dtype=jnp.float64)
        want, upd = jbn.apply(
            {"params": {"scale": scale, "bias": bias},
             "batch_stats": {"mean": mean, "var": var}},
            jnp.asarray(x), mutable=["batch_stats"])
        want = np.asarray(want)
        upd = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
    assert got.dtype == torch.float64 and want.dtype == np.float64
    assert np.abs(got.numpy() - want).max() <= F64_RTOL * np.abs(want).max()
    if train:
        for got_s, k in zip(bn.running_update(), ("mean", "var")):
            assert got_s.dtype == torch.float64
            assert (np.abs(got_s.numpy() - upd[k]).max()
                    <= F64_RTOL * np.abs(upd[k]).max()), k


def test_upsample_and_loss_float64_compute_in_float64():
    """The decoder's bilinear upsample (1/16 → 1/4, then to the input)
    and the cross entropy keep float64 in float64."""
    rng = np.random.default_rng(4)
    y = rng.normal(size=(2, 4, 8, 15))
    got = upsample_bilinear(torch.from_numpy(y), (16, 32), axes=(1, 2))
    with jax.enable_x64(True):
        want = np.asarray(jax.image.resize(jnp.asarray(y), (2, 16, 32, 15),
                                           "bilinear"))
    assert got.dtype == torch.float64
    assert np.abs(got.numpy() - want).max() <= F64_RTOL * np.abs(want).max()
    labels = rng.integers(0, 15, (2, 16, 32))
    labels[0, :3] = 255
    loss = softmax_cross_entropy(got, torch.from_numpy(labels))
    z = want - want.max(-1, keepdims=True)
    logp = z - np.log(np.exp(z).sum(-1, keepdims=True))
    valid = labels != 255
    ref = -np.take_along_axis(logp, np.where(valid, labels, 0)[..., None],
                              -1)[..., 0][valid].mean()
    assert loss.dtype == torch.float64
    assert abs(float(loss) - ref) <= F64_RTOL * abs(ref)
