"""The port's ENet, its fused-trunk executor and its Engine against the
JAX package's Flax ENet (textbook path, ``fast=False``), ``enet_fused_apply``
and Engine, on the same weights (bridged by ``convert/flax_enet.py``) and
the same numpy-made inputs.

Float32 tolerances: logits rtol = atol = 1e-4 (a summation-order budget:
the measured gap is ~5e-6 on logits up to ~6); labels must be equal except
at measured ties, i.e. pixels whose top-two reference logits are within
1e-4 of each other.  bfloat16 engines round at other points than XLA on
the CPU, so there the test measures label agreement and pins a budget.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import synthetic as jsynthetic
from bugcar_image_segmentation_tpu.configs import ModelConfig as JModelConfig
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.models.enet import ENet as JENet
from bugcar_image_segmentation_tpu.models.enet import (
    max_pool_with_indices as jpool, max_unpool as junpool)
from bugcar_image_segmentation_tpu.models.enet_fused import \
    enet_fused_apply as jfused_apply
from bugcar_image_segmentation_tpu.utils.checkpoint import load_variables
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import (
    enet_state_dict, random_enet_variables)
from bugcar_image_segmentation_tpu_torch.models.enet import ENet
from bugcar_image_segmentation_tpu_torch.models.enet_fused import (
    FusedENet, enet_fused_apply)
from bugcar_image_segmentation_tpu_torch.ops import pooling

RTOL = ATOL = 1e-4
TIE = 1e-4
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "enet_synthetic.msgpack")


def _jtree(v):
    return jax.tree_util.tree_map(jnp.asarray, v)


def _labels_equal_except_ties(ref_logits, got_logits):
    top2 = np.sort(ref_logits, axis=-1)[..., -2:]
    decided = (top2[..., 1] - top2[..., 0]) > TIE
    a, b = ref_logits.argmax(-1), got_logits.argmax(-1)
    assert (a[decided] == b[decided]).all()
    return float((~decided).mean())


@pytest.fixture(scope="module")
def small():
    """Seeded Flax-layout weights and a (2, 32, 64, 3) input."""
    v = random_enet_variables(7)
    x = np.random.default_rng(2).standard_normal(
        (2, 32, 64, 3)).astype(np.float32)
    ref = np.asarray(JENet(num_classes=15, dtype=jnp.float32, fast=False)
                     .apply(_jtree(v), jnp.asarray(x), train=False))
    m = ENet(15)
    m.load_state_dict(enet_state_dict(v))
    return v, x, ref, m


def test_enet_logits_match_flax(small):
    v, x, ref, m = small
    with torch.no_grad():
        got = m(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == (2, 32, 64, 15)
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    _labels_equal_except_ties(ref, got.numpy())


def test_fused_executor_matches_flax_and_jax_fused(small):
    v, x, ref, m = small
    jgot = np.asarray(jfused_apply(_jtree(v), jnp.asarray(x), num_classes=15,
                                   dtype=jnp.float32, interpret=True))
    with torch.no_grad():
        got = FusedENet(m)(torch.from_numpy(x)).numpy()
        once = enet_fused_apply(m, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, jgot, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got, once)
    _labels_equal_except_ties(ref, got)


def test_bridge_covers_the_whole_tree(small):
    v, _, _, m = small
    sd = enet_state_dict(v)
    assert set(sd) == set(m.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(v))
    assert len(sd) == n_leaves == 508


def test_flax_init_tree_bridges():
    """The tree Flax's own init makes (shapes via eval_shape) maps onto
    the port's state dict key for key and shape for shape."""
    mod = JENet(num_classes=15, dtype=jnp.float32, fast=False)
    shapes = jax.eval_shape(
        lambda: mod.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 3)),
                         train=False))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  shapes)
    sd = enet_state_dict(tree)
    want = ENet(15).state_dict()
    assert set(sd) == set(want)
    for key, t in want.items():
        assert sd[key].shape == t.shape, key


def test_trained_checkpoint_full_width():
    """enet_synthetic.msgpack (read with the JAX package's loader, in this
    test only) at the full 512x256: the port's ENet and fused executor
    against Flax ENet, f32, on a synthetic road scene."""
    variables, _ = load_variables(CKPT)
    frame = jsynthetic.road_scene(np.random.default_rng(4), (256, 512))[0]
    cfg = JModelConfig(dtype="float32")
    jeng = jbuild("enet", cfg, variables=variables)
    ref = np.asarray(jeng.logits(frame))
    tree = jax.tree_util.tree_map(np.asarray, variables)
    for name in ("enet", "enet_fused"):
        eng = port.build_engine(name, port.ModelConfig(dtype="float32"),
                                variables=tree, device="cpu")
        got = eng.logits(frame).numpy()
        assert got.shape == (256, 512, 15)
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
        ties = _labels_equal_except_ties(ref, got)
        assert ties < 1e-3, ties
        np.testing.assert_array_equal(
            eng.predict(frame).numpy()[~_tie_mask(ref)],
            np.asarray(jeng.predict(frame))[~_tie_mask(ref)])


def _tie_mask(logits):
    top2 = np.sort(logits, axis=-1)[..., -2:]
    return (top2[..., 1] - top2[..., 0]) <= TIE


ENGINE_CFG = dict(input_width=64, input_height=32)


@pytest.fixture(scope="module")
def engine_ref():
    """The JAX package's "enet" engine on seeded weights, f32 and bf16:
    logits / labels of a frame batch (96x48 frames, resized on device)."""
    v = random_enet_variables(11)
    frames = np.random.default_rng(3).integers(0, 256, (4, 48, 96, 3),
                                               np.uint8)
    j32 = jbuild("enet", JModelConfig(dtype="float32", **ENGINE_CFG),
                 variables=_jtree(v))
    j16 = jbuild("enet", JModelConfig(**ENGINE_CFG), variables=_jtree(v))
    return dict(v=v, frames=frames, logits=np.asarray(j32.logits(frames)),
                labels=np.asarray(j32.predict(frames)),
                labels16=np.asarray(j16.predict(frames)))


@pytest.mark.parametrize("name", ["enet", "enet_fused"])
def test_engine_predict_f32_matches_jax(name, engine_ref):
    r = engine_ref
    eng = port.build_engine(
        name, port.ModelConfig(name=name, dtype="float32", **ENGINE_CFG),
        variables=r["v"], device="cpu")
    got = eng.logits(r["frames"]).numpy()
    np.testing.assert_allclose(got, r["logits"], rtol=RTOL, atol=ATOL)
    tie = _tie_mask(r["logits"])
    labels = eng.predict(r["frames"]).numpy()
    assert labels.dtype == np.uint8 and labels.shape == (4, 32, 64)
    np.testing.assert_array_equal(labels[~tie], r["labels"][~tie])
    road = np.isin(r["logits"].argmax(-1), (0, 1)).astype(np.uint8)
    binary = eng.predict_binary(r["frames"]).numpy()
    np.testing.assert_array_equal(binary[~tie], road[~tie])
    np.testing.assert_array_equal(eng.predict(r["frames"][0]).numpy(),
                                  labels[0])


@pytest.mark.parametrize("name", ["enet", "enet_fused"])
def test_engine_bf16_label_agreement_budget(name, engine_ref):
    """bf16 compute, seeded random weights: the port's labels agree with
    the JAX bf16 engine's on >= 99% of pixels (measured 0.994-0.995 on
    such weights; 0.99997 on the trained checkpoint at 512x256)."""
    r = engine_ref
    eng = port.build_engine(name, port.ModelConfig(name=name, **ENGINE_CFG),
                            variables=r["v"], device="cpu")
    assert eng.module.dtype == torch.bfloat16
    agree = (eng.predict(r["frames"]).numpy() == r["labels16"]).mean()
    assert agree >= 0.99, agree


def test_engine_self_init_is_seeded():
    cfg = port.ModelConfig(input_width=32, input_height=16, dtype="float32")
    a = port.build_engine("enet", cfg, device="cpu", seed=1)
    b = port.build_engine("enet", cfg, device="cpu", seed=1)
    c = port.build_engine("enet", cfg, device="cpu", seed=2)
    frame = np.random.default_rng(0).integers(0, 256, (16, 32, 3), np.uint8)
    assert torch.equal(a.logits(frame), b.logits(frame))
    assert not torch.equal(a.logits(frame), c.logits(frame))


def test_unported_models_raise():
    # every engine name of the JAX package is ported (the SegFormer
    # _int8 / _hc variants last: tests/test_torch_segformer_variants.py)
    assert port.build_engine("segformer_b0_hc", device="cpu").cascade
    with pytest.raises(ValueError, match="unknown model"):
        port.build_engine("fcn", device="cpu")


def test_input_shape_checked():
    with pytest.raises(ValueError, match="divisible by 8"):
        ENet(15)(torch.zeros(1, 12, 16, 3))


@pytest.mark.parametrize("ties", [False, True])
def test_pool_with_indices_and_unpool_match_jax(ties):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 6, 5)).astype(np.float32)
    if ties:   # quantised: many windows hold repeated maxima
        x = np.round(x).astype(np.float32)
    jp, ji = jpool(jnp.asarray(x))
    tp, ti = pooling.max_pool_with_indices(torch.from_numpy(x))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.uint8
    np.testing.assert_array_equal(
        pooling.max_unpool(tp, ti).numpy(),
        np.asarray(junpool(jp, ji)))
