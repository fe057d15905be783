"""The port's DeepLabV3+ on Xception-65 (``models/xception.py``,
``models/deeplab.py``) and its weight bridge (``convert/flax_xception.py``)
against the JAX package's Flax ``Xception65DeepLab``, on the same weights
and the same numpy-made inputs.

float32, two middle blocks at 64x128: the port's plain and ``_fs``
models against the JAX plain model and the JAX ``_fs`` model (its Pallas
sepconv in interpret mode), logits rtol = atol = 1e-4 (a summation-order
budget; the measured gap is ~1.5-2e-4 absolute on logits up to ~70, under
3e-6 relative).  On the CPU the fused sites run the kernel's plain
version; a counting stub shows which sites the kernel takes.  The trained
checkpoint is read with the JAX package's loader, in this test only.
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
from bugcar_image_segmentation_tpu.models.xception import \
    Xception65DeepLab as JX
from bugcar_image_segmentation_tpu.utils.checkpoint import load_variables
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.convert.flax_xception import (
    random_xception_variables, xception_state_dict)
from bugcar_image_segmentation_tpu_torch.models import xception as px
from bugcar_image_segmentation_tpu_torch.models.api import xception_variant
from bugcar_image_segmentation_tpu_torch.ops.cuda.sepconv import \
    sepconv_reference

RTOL = ATOL = 1e-4
MIDDLE = 2
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "deeplab_xception_synthetic.msgpack")
# (fused_sepconv, head_upsample) variants held against Flax.
VARIANTS = [(False, "full"), (True, "full"), (False, "quarter"),
            (True, "quarter")]


def _port(variables, x, **kw):
    m = px.Xception65DeepLab(middle_blocks=MIDDLE, **kw).eval()
    m.load_state_dict(xception_state_dict(variables))
    with torch.no_grad():
        return m(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def flax():
    """Seeded Flax-layout weights (middle_blocks=2), a (2, 64, 128, 3)
    input, and the JAX logits of each variant."""
    v = random_xception_variables(3, middle_blocks=MIDDLE)
    x = np.random.default_rng(1).standard_normal(
        (2, 64, 128, 3)).astype(np.float32)
    want = {}
    for fs, hu in VARIANTS:
        mod = JX(middle_blocks=MIDDLE, dtype=jnp.float32, fused_sepconv=fs,
                 head_upsample=hu)
        want[fs, hu] = np.asarray(jax.jit(
            lambda vv, a: mod.apply(vv, a, train=False))(v, x))
    return v, x, want


@pytest.mark.parametrize("fs,hu", VARIANTS,
                         ids=[f"fs{int(fs)}-{hu}" for fs, hu in VARIANTS])
def test_matches_flax(flax, fs, hu):
    v, x, want = flax
    got = _port(v, x, fused_sepconv=fs, head_upsample=hu)
    side = (64, 128) if hu == "full" else (16, 32)
    assert got.shape == want[fs, hu].shape == (2, *side, 15)
    np.testing.assert_allclose(got, want[fs, hu], rtol=RTOL, atol=ATOL)


def test_labels_are_not_degenerate():
    """A seeded engine at full depth tells pixels apart on synthetic road
    frames: no class takes 0.99 of the pixels, so label agreements
    elsewhere (and on the card) mean something."""
    frames = np.stack([f for f, _, _ in jsynthetic.video(
        seed=0, num_frames=2, shape=(480, 640))])
    eng = port.build_engine("deeplab_xception", port.ModelConfig(
        name="deeplab_xception", input_width=256, input_height=128,
        dtype="float32"), device="cpu")
    share = np.bincount(eng.logits(frames).argmax(-1).numpy().ravel(),
                        minlength=15) / (2 * 128 * 256)
    assert share.max() < 0.99 and (share > 0.01).sum() >= 2, share


def _count_sites(monkeypatch, model, x):
    """Forward ``x`` with the kernel wrapper replaced by a stub that
    counts the calls and checks that each input is NHWC-contiguous."""
    calls = []

    def stub(xx, *args, **kw):
        assert xx.is_contiguous(), tuple(xx.shape)
        calls.append((tuple(xx.shape), kw["strides"]))
        return sepconv_reference(xx, *args, **kw)

    monkeypatch.setattr(px, "fused_sepconv", stub)
    with torch.no_grad():
        model(torch.from_numpy(x))
    return calls


@pytest.mark.parametrize("choice,count", [
    (True, 7 + 3 * MIDDLE), ("all", 7 + 3 * MIDDLE), ("entry", 7),
    ("middle", 3 * MIDDLE), ("block1", 3), ("block2", 2), (False, 0)])
def test_kernel_sites(monkeypatch, flax, choice, count):
    """The JAX gate: every dilation-1 sepconv of the chosen flows, block
    1's stride-2 sep2 (C = 128) but not block 2's or 3's (C = 256, 728),
    never the dilation-2 exit flow: 7 + 3 * middle_blocks in all."""
    v, x, _ = flax
    m = px.Xception65DeepLab(middle_blocks=MIDDLE, fused_sepconv=choice)
    m.load_state_dict(xception_state_dict(v))
    calls = _count_sites(monkeypatch, m.eval(), x)
    assert len(calls) == count
    assert sum(s == 2 for _, s in calls) == (1 if choice in (
        True, "all", "entry", "block1") else 0)
    # batched, one launch per site per backbone batch
    assert len(_count_sites(monkeypatch, m, np.concatenate([x, x]))) == count


def test_bridge_covers_the_flax_tree(flax):
    """Flax's own init tree (shapes via eval_shape) maps onto the port key
    for key and shape for shape; the _fs model declares the same tree;
    the seeded tree has the same structure."""
    v, _, _ = flax
    for fs in (False, True):
        mod = JX(num_classes=7, middle_blocks=3, dtype=jnp.float32,
                 fused_sepconv=fs)
        shapes = jax.eval_shape(lambda: mod.init(
            jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False))
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
        sd = xception_state_dict(tree)
        want = px.Xception65DeepLab(num_classes=7,
                                    middle_blocks=3).state_dict()
        assert set(sd) == set(want)
        for key, t in want.items():
            assert sd[key].shape == t.shape, key
    assert (jax.tree_util.tree_structure(v) == jax.tree_util.tree_structure(
        random_xception_variables(0, middle_blocks=MIDDLE)))


def test_bridge_layouts():
    v = random_xception_variables(1, middle_blocks=1, num_classes=5)
    sd = xception_state_dict(v)
    p = v["params"]
    assert sd["block1.sep0.depthwise.weight"].shape == (64, 1, 3, 3)
    np.testing.assert_array_equal(
        sd["block1.sep0.depthwise.weight"].numpy(),
        p["block1"]["sep0"]["depthwise"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["middle0.sep1.pointwise.weight"].shape == (728, 728, 1, 1)
    assert sd["conv1_1.Conv_0.weight"].shape == (32, 3, 3, 3)
    assert sd["classifier.bias"].shape == (5,)
    np.testing.assert_array_equal(sd["aspp.merge.BatchNorm_0.var"].numpy(),
                                  v["batch_stats"]["aspp"]["merge"]
                                  ["BatchNorm_0"]["var"])
    again = random_xception_variables(1, middle_blocks=1, num_classes=5)
    np.testing.assert_array_equal(again["params"]["dec0"]["Conv_0"]["kernel"],
                                  p["dec0"]["Conv_0"]["kernel"])


def test_bridge_is_strict():
    """Every leaf consumed exactly once: a missing leaf, a leaf with no
    place, a wrong shape or a 2-D kernel raises."""
    def fresh():
        return random_xception_variables(2, middle_blocks=1, num_classes=5)

    v = fresh()
    del v["batch_stats"]["block2"]["sep1"]["pointwise_bn"]["var"]
    with pytest.raises(ValueError, match="unfilled"):
        xception_state_dict(v)
    v = fresh()
    v["params"]["block2"]["sep1"]["extra"] = {"kernel": np.zeros(
        (1, 1, 2, 2), np.float32)}
    with pytest.raises(ValueError, match="no place"):
        xception_state_dict(v)
    v = fresh()
    v["params"]["dec1"]["Conv_0"]["kernel"] = np.zeros((3, 3, 256, 255),
                                                       np.float32)
    with pytest.raises(ValueError, match="shape"):
        xception_state_dict(v)
    v = fresh()
    v["params"]["dec1"]["Conv_0"]["kernel"] = np.zeros((256, 256),
                                                       np.float32)
    with pytest.raises(ValueError, match="4-D"):
        xception_state_dict(v)
    with pytest.raises(ValueError, match="Xception"):
        xception_state_dict({"params": {}})


def test_engine_grammar_and_defaults():
    # (quarter head, int8 pointwise, fused sepconvs)
    assert xception_variant("xception") == (False, False, False)
    assert xception_variant("deeplab_xception_fs") == (False, False, True)
    assert xception_variant("xception_q_fs") == (True, False, True)
    assert xception_variant("deeplab_xception_fs_q") == (True, False, True)
    # _int8 is ported (its engines: tests/test_torch_xception_int8.py)
    assert xception_variant("deeplab_xception_q_int8_fs") == (True, True,
                                                              True)
    for name in ("xception_fz", "deeplab_xception_w8"):
        with pytest.raises(ValueError, match="grammar"):
            port.build_engine(name, device="cpu")
    eng = port.build_engine("deeplab_xception_q_fs", device="cpu")
    assert (eng.cfg.input_width, eng.cfg.input_height,
            eng.cfg.num_classes) == (1024, 512, 15)
    assert eng.label_scale == 4 and eng.module.fused_sepconv is True
    # Xception and ENet batch: whole-batch logits equal single-frame ones
    # on the card (tests/test_torch_cuda.py); SegFormer does not
    assert not eng.frame_by_frame
    assert not port.build_engine("enet", device="cpu").frame_by_frame
    assert eng.module.middle_blocks == 16
    assert eng.module.dtype == torch.bfloat16
    assert eng.module.block1.sep0.depthwise_bn.scale.dtype == torch.float32
    # the kernel's arguments are folded from the f32 parameters, the
    # pointwise weights rounded once to the compute dtype
    args = eng.module.middle3.sep2._kernel_args
    assert args["wdw"].dtype == args["s2"].dtype == torch.float32
    assert args["wpw"].dtype == torch.bfloat16
    assert args["wpw"].shape == (728, 728)


def test_input_checks():
    m = px.Xception65DeepLab(middle_blocks=1)
    with pytest.raises(ValueError, match="divisible by 16"):
        m(torch.zeros(1, 40, 64, 3))
    with pytest.raises(ValueError, match="head_upsample"):
        px.Xception65DeepLab(head_upsample="half")
    with pytest.raises(ValueError, match="fused_sepconv"):
        px.Xception65DeepLab(fused_sepconv="exit")


# Trained checkpoint at its own 512x256, bf16 labels of the port against
# the JAX bf16 engine on these two synthetic road scenes (CPU, both bf16):
# measured 0.99989 for the plain and for the _fs engine (29 and 30 of
# 262,144 pixels differ); pinned at 0.999.  The f32 logits differ by at
# most 1.03e-4 (logits up to ~15).
CKPT_AGREE_BF16 = 0.999


def test_trained_checkpoint():
    """deeplab_xception_synthetic.msgpack (bf16 leaves, taken as f32;
    read with the JAX package's loader, in this test only) through the
    port's plain and _fs engines: float32 logits against the JAX f32
    engine within rtol = atol = 1e-4; bf16 labels against the JAX bf16
    engine at the pinned agreement."""
    variables, cfg = load_variables(CKPT)
    assert (cfg.input_width, cfg.input_height) == (512, 256)
    rng = np.random.default_rng(8)
    frames = np.stack([jsynthetic.road_scene(rng, (256, 512))[0]
                       for _ in range(2)])
    # The leaves are bf16; both sides take them as f32 (Flax would
    # otherwise fold the BatchNorm statistics in bf16 arithmetic).
    tree = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                  variables)
    jcfg = dict(name="deeplab_xception", input_width=512, input_height=256)
    j32 = jbuild("deeplab_xception", JModelConfig(dtype="float32", **jcfg),
                 variables=tree)
    want32 = np.asarray(j32.logits(frames[0]))
    j16 = jbuild("deeplab_xception", JModelConfig(**jcfg), variables=tree)
    want16 = np.asarray(j16.predict(frames))
    for name in ("deeplab_xception", "deeplab_xception_fs"):
        eng32 = port.build_engine(name, port.ModelConfig(dtype="float32",
                                                         **jcfg),
                                  variables=tree, device="cpu")
        got32 = eng32.logits(frames[0]).numpy()
        np.testing.assert_allclose(got32, want32, rtol=RTOL, atol=ATOL)
        eng16 = port.build_engine(name, port.ModelConfig(**jcfg),
                                  variables=tree, device="cpu")
        got16 = eng16.predict(frames).numpy()
        assert got16.shape == (2, 256, 512) and got16.dtype == np.uint8
        agree = float((got16 == want16).mean())
        assert agree >= CKPT_AGREE_BF16, (name, agree)
