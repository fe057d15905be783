"""One train step of UNet, the MobileNetV2 DeepLab and SegFormer-B0 (small
widths) in the port against the JAX package's, from the same tree: the
port's ``create_train_state`` tree, carried to Flax by the inverse
bridge.  SegFormer trains through the plain attention and the full head,
as the Flax module does in train mode.

As in tests/test_torch_training.py, the JAX step runs in float64 (its
float32 gradients move by kinks: ReLU / ReLU6 and max pools) and the step
is held in two parts: the gradients against JAX's, and the AdamW update
against ``optax.adamw``'s update by the port's own gradients.  Then the
eval step's logits after the step against JAX's ``make_eval_step`` on
the same weights, and the quarter head giving way to the full one in
train mode.

Some gradients are zero in exact arithmetic: a bias whose per-channel
constant reaches a train-mode BatchNorm through linear maps only
(SegFormer's ``linear_c*`` and ``norm3`` biases; DeepLab's projection
BatchNorm biases, whose residual stream feeds only 1x1 convs and
BatchNorms at this size), or a softmax over keys (SegFormer's ``k``
biases), and likewise the batch means after them.  JAX's float64 gives
them at most 1e-8 of the largest leaf's norm, float32 ~1e-9 to 3e-8
(rounding noise); AdamW turns that
noise into updates of up to lr, which eval mode does not cancel -- so
the eval step is held on the port's trained weights, not JAX's.

Tolerances (measured on the CPU, pinned with margin): loss 1e-5
relative (measured <= 5.8e-7); relative L2 error of a leaf's gradient
5e-2 (measured UNet 2.9e-6, DeepLab 4.6e-3: its ReLU6 kinks, SegFormer
2.6e-5), or, for a zero-in-exact-arithmetic leaf (JAX norm below 1e-8 of
the largest leaf's), a norm below 1e-6 of the largest (measured <=
3.2e-8); updated parameters within 1e-3 lr of optax's (measured 2.7e-5
lr); running statistics within 5e-5 of max(their leaf's max, 0.1)
(measured <= 5.1e-6); eval logits 1e-4 of their max (measured <=
7.7e-7).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from bugcar_image_segmentation_tpu.models.deeplab import \
    DeepLabV3 as JDeepLab
from bugcar_image_segmentation_tpu.models.segformer import \
    SegFormer as JSegFormer
from bugcar_image_segmentation_tpu.models.unet import UNet as JUNet
from bugcar_image_segmentation_tpu.training import (
    TrainState as JTrainState, make_eval_step as jeval,
    softmax_cross_entropy as jce)
from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
    flax_variables
from bugcar_image_segmentation_tpu_torch.models.deeplab import DeepLabV3
from bugcar_image_segmentation_tpu_torch.models.segformer import SegFormer
from bugcar_image_segmentation_tpu_torch.models.unet import UNet
from bugcar_image_segmentation_tpu_torch.training import (
    create_train_state, make_eval_step, make_train_step)

LR = 3e-3
SEG = dict(widths=(16, 32, 40, 64), depths=(1, 1, 1, 1), decoder_dim=32)
# name: (port model, JAX model of a dtype, input (H, W))
MODELS = {
    "unet": (lambda: UNet(15, widths=(8, 16), bottleneck_width=32),
             lambda dt: JUNet(num_classes=15, widths=(8, 16),
                              bottleneck_width=32, dtype=dt), (32, 64)),
    "deeplab": (lambda: DeepLabV3(15),
                lambda dt: JDeepLab(num_classes=15, dtype=dt), (32, 64)),
    "segformer": (lambda: SegFormer(15, **SEG),
                  lambda dt: JSegFormer(num_classes=15, dtype=dt,
                                        chw_stages=0, chw_head=False, **SEG),
                  (64, 64)),
}
GRAD_L2 = 5e-2
ZERO_GRAD = 1e-6
LOGIT_RTOL = 1e-4
STATS_RTOL = 5e-5


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


def as_numpy(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def l2_rel(a, b):
    return float(np.linalg.norm(np.asarray(a, np.float64) - b)
                 / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module", params=sorted(MODELS))
def step_pair(request):
    """(name, port result, JAX result) of one step from one tree."""
    make_port, make_jax, hw = MODELS[request.param]
    model = make_port()
    state = create_train_state(model, (1,) + hw + (3,), learning_rate=LR,
                               device="cpu", seed=2)
    tree = flax_variables(model)
    rng = np.random.default_rng(1)
    images = rng.normal(size=(2,) + hw + (3,)).astype(np.float32)
    labels = rng.integers(0, 15, (2,) + hw).astype(np.int32)
    labels[1, -5:] = 255
    with jax.enable_x64(True):
        jm = make_jax(jnp.float64)
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        js = JTrainState.create(apply_fn=jm.apply,
                                params=cast(tree["params"]),
                                batch_stats=cast(tree["batch_stats"]),
                                tx=optax.adamw(LR))
        x64 = jnp.asarray(images, jnp.float64)
        js, loss, grads = jax.jit(jax_step(jm))(js, x64, labels)
        want = dict(loss=float(loss), grads=as_numpy(grads),
                    stats=as_numpy(js.batch_stats))
    x, y = torch.from_numpy(images), torch.from_numpy(labels)
    state, loss = make_train_step(model)(state, x, y)
    twin = make_port()
    twin.load_state_dict({**model.state_dict(), **{
        k: p.grad for k, p in model.named_parameters()}})
    after = flax_variables(model)
    got = dict(loss=float(loss), grads=flax_variables(twin)["params"],
               params=after["params"], stats=after["batch_stats"],
               logits=make_eval_step(model)(state, x).numpy())
    with jax.enable_x64(True):
        js = js.replace(params=cast(after["params"]),
                        batch_stats=cast(after["batch_stats"]))
        want["logits"] = np.asarray(jax.jit(jeval(jm))(js, x64))
    return request.param, tree, got, want


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


def optax_update(tree, grads):
    """optax.adamw(LR)'s first update of ``tree``'s params by ``grads``."""
    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda a: jnp.asarray(a, jnp.float64), t)
        tx = optax.adamw(LR)

        @jax.jit
        def update(params, grads):
            upd, _ = tx.update(grads, tx.init(params), params)
            return optax.apply_updates(params, upd)

        return as_numpy(update(cast(tree["params"]), cast(grads)))


def test_train_step_loss_and_gradients_match_jax(step_pair):
    name, _, got, want = step_pair
    assert abs(got["loss"] - want["loss"]) <= 1e-5 * want["loss"], name
    grads = dict(leaves(want["grads"]))
    assert sorted(grads) == sorted(dict(leaves(got["grads"])))
    top = max(np.linalg.norm(g) for g in grads.values())
    for k, g in leaves(got["grads"]):
        if np.linalg.norm(grads[k]) < 1e-8 * top:      # zero, exactly
            assert np.linalg.norm(g) <= ZERO_GRAD * top, (name, k)
        else:
            assert l2_rel(g, grads[k]) <= GRAD_L2, (name, k)


def test_train_step_update_and_stats_match(step_pair):
    name, tree, got, want = step_pair
    params = dict(leaves(optax_update(tree, got["grads"])))
    for k, p in leaves(got["params"]):
        assert np.abs(p - params[k]).max() <= 1e-3 * LR, (name, k)
    stats = dict(leaves(want["stats"]))
    assert sorted(stats) == sorted(dict(leaves(got["stats"])))
    for k, s in leaves(got["stats"]):
        assert np.abs(s - stats[k]).max() <= (
            STATS_RTOL * max(np.abs(stats[k]).max(), 0.1)), (name, k)


def test_eval_after_step_matches_jax(step_pair):
    name, _, got, want = step_pair
    assert got["logits"].shape == want["logits"].shape
    err = np.abs(got["logits"] - want["logits"]).max()
    assert err <= LOGIT_RTOL * np.abs(want["logits"]).max(), (name, err)


@pytest.mark.parametrize("name", ["deeplab", "segformer"])
def test_train_mode_takes_the_full_head(name):
    """The quarter head serves only in eval mode; a train-mode forward
    gives full-resolution logits, as the Flax modules do."""
    model = (DeepLabV3(15, head_upsample="quarter") if name == "deeplab"
             else SegFormer(15, head_upsample="quarter", head_cascade=True,
                            **SEG))
    create_train_state(model, (1, 64, 64, 3), device="cpu")
    x = torch.zeros(1, 64, 64, 3)
    with torch.no_grad():
        assert model.eval()(x).shape == (1, 16, 16, 15)
        assert model.train()(x).shape == (1, 64, 64, 15)
