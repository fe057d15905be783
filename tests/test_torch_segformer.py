"""The port's SegFormer (``models/segformer.py``) and its weight bridge
(``convert/flax_segformer.py``) against the JAX package's Flax SegFormer,
on the same weights and the same numpy-made inputs.

The port has one forward, the textbook NHWC one; it is held against both
JAX layouts in float32:

- Flax ``SegFormer(chw_stages=0, chw_head=False)``, the NHWC path: logits
  rtol = atol = 1e-4 (a summation-order budget; the measured gap is
  ~2-4e-6 on seeded weights with logits up to ~3, 1.1e-5 on the trained
  checkpoint's logits up to 25);
- the default Flax module (transposed stages and head, the JAX kernel
  ``flash_attention_t``): ``atol = 2e-4 * max|y|``, the JAX package's own
  budget between its two layouts (tests/test_models.py).

The attention runs the plain version on the CPU (the CUDA kernel is held
against it on the card, tests/test_torch_cuda.py).  bfloat16 rounds at
other points than XLA on the CPU, so the trained checkpoint's bf16 labels
are held to a measured, pinned agreement budget.
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
from bugcar_image_segmentation_tpu.models.segformer import SegFormer as JSF
from bugcar_image_segmentation_tpu.utils.checkpoint import load_variables
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import (
    random_segformer_variables, segformer_state_dict)
from bugcar_image_segmentation_tpu_torch.models.segformer import (
    SEGFORMER_PRESETS, SegFormer)

RTOL = ATOL = 1e-4
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "segformer_b0_synthetic.msgpack")
# Small widths: every stage's head dim is 8, decoder 32, 5 classes.
SMALL = dict(num_classes=5, widths=(8, 16, 40, 64), depths=(1, 2, 1, 1),
             decoder_dim=32)
# (torch_compat, head_upsample) variants the small model runs.
VARIANTS = [(False, "full"), (True, "quarter"), (False, "quarter"),
            (True, "full")]


def _jit_apply(module, variables, x):
    return np.asarray(jax.jit(lambda v, a: module.apply(v, a, train=False))(
        variables, x))


def _port(variables, x, **kw):
    m = SegFormer(**kw).eval()
    m.load_state_dict(segformer_state_dict(variables))
    with torch.no_grad():
        return m(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def small():
    """Seeded Flax-layout weights of the small model (the tree is the same
    for every variant), a (2, 64, 64, 3) input, and the JAX logits of each
    variant on the NHWC and on the default transposed path."""
    v = random_segformer_variables(5, **SMALL)
    x = np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = {}
    for tc, hu in VARIANTS:
        kw = dict(SMALL, dtype=jnp.float32, torch_compat=tc, head_upsample=hu)
        want[tc, hu] = (
            _jit_apply(JSF(chw_stages=0, chw_head=False, **kw), v, x),
            _jit_apply(JSF(**kw), v, x))
    return v, x, want


@pytest.mark.parametrize("tc,hu", VARIANTS,
                         ids=[f"compat{int(tc)}-{hu}" for tc, hu in VARIANTS])
def test_small_matches_flax_nhwc_and_chw(small, tc, hu):
    v, x, want = small
    got = _port(v, x, torch_compat=tc, head_upsample=hu, **SMALL)
    nhwc, chw = want[tc, hu]
    side = 64 if hu == "full" else 16
    assert got.shape == nhwc.shape == (2, side, side, 5)
    np.testing.assert_allclose(got, nhwc, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, chw, atol=2e-4 * np.abs(chw).max())


@pytest.fixture(scope="module")
def b0():
    """B0 widths at 64x64: seeded weights (random_segformer_variables) and
    the JAX logits of the NHWC and the default transposed path."""
    v = random_segformer_variables(9)
    x = np.random.default_rng(4).standard_normal(
        (1, 64, 64, 3)).astype(np.float32)
    nhwc = _jit_apply(JSF(dtype=jnp.float32, chw_stages=0, chw_head=False),
                      v, x)
    chw = _jit_apply(JSF(dtype=jnp.float32), v, x)
    return v, x, nhwc, chw


def test_b0_matches_flax_nhwc_and_chw(b0):
    v, x, nhwc, chw = b0
    got = _port(v, x)
    assert got.shape == (1, 64, 64, 15)
    np.testing.assert_allclose(got, nhwc, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, chw, atol=2e-4 * np.abs(chw).max())


def test_b0_plain_attention_switch_is_the_same_math(b0):
    """``xla_attention`` routes attention through the plain version; on
    the CPU the kernel wrappers run that same plain version."""
    v, x, _, _ = b0
    m = SegFormer().eval()
    m.load_state_dict(segformer_state_dict(v))
    with torch.no_grad():
        a = m(torch.from_numpy(x))
        m.xla_attention = True
        b = m(torch.from_numpy(x))
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_bridge_covers_the_flax_tree():
    """The tree Flax's own init makes (shapes via eval_shape) maps onto
    the port's state dict key for key and shape for shape, for B0 and B2;
    the seeded tree has the same structure."""
    for size in ("b0", "b2"):
        mod = JSF.preset(size, num_classes=7, dtype=jnp.float32)
        shapes = jax.eval_shape(
            lambda: mod.init(jax.random.PRNGKey(0),
                             jnp.zeros((1, 64, 64, 3)), train=False))
        tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                      shapes)
        sd = segformer_state_dict(tree)
        want = SegFormer.preset(size, num_classes=7).state_dict()
        assert set(sd) == set(want)
        for key, t in want.items():
            assert sd[key].shape == t.shape, key
        seeded = random_segformer_variables(0, size, 7)
        assert (jax.tree_util.tree_structure(seeded)
                == jax.tree_util.tree_structure(tree))
        assert (jax.tree_util.tree_map(np.shape, seeded)
                == jax.tree_util.tree_map(np.shape, tree))


def test_bridge_layouts():
    """Dense kernels (in, out) → (out, in); conv kernels HWIO → OIHW (the
    depthwise (3, 3, 1, C) → (C, 1, 3, 3)); norms and statistics as they
    are; the seeded tree is seeded."""
    v = random_segformer_variables(1)
    sd = segformer_state_dict(v)
    p = v["params"]
    np.testing.assert_array_equal(
        sd["stage1_block0.attn.q.weight"].numpy(),
        p["stage1_block0"]["attn"]["q"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["stage0_block0.ffn.dwconv.weight"].numpy(),
        p["stage0_block0"]["ffn"]["dwconv"]["kernel"].transpose(3, 2, 0, 1))
    assert sd["stage0_block0.ffn.dwconv.weight"].shape == (128, 1, 3, 3)
    assert sd["fuse.weight"].shape == (256, 1024, 1, 1)
    np.testing.assert_array_equal(sd["fuse_bn.var"].numpy(),
                                  v["batch_stats"]["fuse_bn"]["var"])
    np.testing.assert_array_equal(sd["norm3.scale"].numpy(),
                                  p["norm3"]["scale"])
    again = random_segformer_variables(1)
    other = random_segformer_variables(2)
    np.testing.assert_array_equal(again["params"]["fuse"]["kernel"],
                                  p["fuse"]["kernel"])
    assert not np.array_equal(other["params"]["fuse"]["kernel"],
                              p["fuse"]["kernel"])


def test_presets_and_unported_flags():
    assert set(SEGFORMER_PRESETS) == {"b0", "b1", "b2", "b3"}
    b2 = SegFormer.preset("b2", num_classes=7)
    assert b2.depths == (3, 4, 6, 3) and b2.fuse.weight.shape[0] == 768
    # quant (_int8) and head_cascade (_hc) are ported, with the folded
    # head (tests/test_torch_segformer_variants.py); the textbook head
    # stays the plain model's
    assert SegFormer(quant=True).folded_head
    assert SegFormer(head_cascade=True).folded_head
    assert not SegFormer().folded_head
    with pytest.raises(ValueError, match="head_upsample"):
        SegFormer(head_upsample="half")
    with pytest.raises(ValueError, match="divisible by 32"):
        SegFormer()(torch.zeros(1, 48, 64, 3))


def test_compute_dtype_keeps_norms_f32():
    m = SegFormer(**SMALL).to_compute_dtype(torch.bfloat16)
    assert m.dtype == torch.bfloat16
    assert m.stage0_block0.attn.q.weight.dtype == torch.bfloat16
    assert m.embed0.Conv_0.weight.dtype == torch.bfloat16
    assert m.stage0_block0.norm1.scale.dtype == torch.float32
    assert m.fuse_bn.scale.dtype == torch.float32
    assert m.fuse_bn.var.dtype == torch.float32


# Trained checkpoint, bf16 labels of the port vs the JAX engine at the
# checkpoint's own 512x256 on these two synthetic road scenes: measured
# 0.99997 (7 of 262,144 pixels differ; CPU, both bf16); pinned at 0.999.
CKPT_AGREE_BF16 = 0.999


def test_trained_checkpoint_bf16_label_budget():
    """segformer_b0_synthetic.msgpack (read with the JAX package's loader,
    in this test only) at its own 512x256: the port's bf16 engine against
    the JAX bf16 engine; float32 logits within rtol = atol = 1e-4."""
    variables, cfg = load_variables(CKPT)
    assert (cfg.input_width, cfg.input_height) == (512, 256)
    rng = np.random.default_rng(8)
    frames = np.stack([jsynthetic.road_scene(rng, (256, 512))[0]
                       for _ in range(2)])
    tree = jax.tree_util.tree_map(np.asarray, variables)
    jcfg = dict(name="segformer_b0", input_width=512, input_height=256)
    j16 = jbuild("segformer_b0", JModelConfig(**jcfg), variables=variables)
    want16 = np.asarray(j16.predict(frames))
    eng16 = port.build_engine("segformer_b0", port.ModelConfig(**jcfg),
                              variables=tree, device="cpu")
    got16 = eng16.predict(frames).numpy()
    assert got16.shape == (2, 256, 512) and got16.dtype == np.uint8
    agree = float((got16 == want16).mean())
    assert agree >= CKPT_AGREE_BF16, agree
    # the same weights in float32, one frame: logits
    j32 = jbuild("segformer_b0", JModelConfig(dtype="float32", **jcfg),
                 variables=variables)
    eng32 = port.build_engine("segformer_b0",
                              port.ModelConfig(dtype="float32", **jcfg),
                              variables=tree, device="cpu")
    np.testing.assert_allclose(eng32.logits(frames[0]).numpy(),
                               np.asarray(j32.logits(frames[0])),
                               rtol=RTOL, atol=ATOL)
