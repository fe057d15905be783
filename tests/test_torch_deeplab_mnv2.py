"""The port's DeepLabV3+ over MobileNetV2 (``models/deeplab.py``), its
weight bridge (``convert/flax_deeplab.py``) and its engines against the JAX
package's, on the same weights and the same numpy-made frames.

The JAX engines run the MobileNetV2 stem as a space-to-depth matmul and
ASPP's dilated branches as shifted matmuls at inference (TPU relayouts of
the same sums); the port runs the textbook convs, so float32 logits are
held within 2e-4 * max|logit| of Flax, and the grids built from them must
be equal.  bf16 rounds at other points on each side: label agreement is
measured and pinned (seeded weights and the trained checkpoint).  The
trained checkpoint is read with the port's msgpack-free loader.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import synthetic as jsynthetic
from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_deeplab import (
    deeplab_state_dict, random_deeplab_variables)
from bugcar_image_segmentation_tpu_torch.models.deeplab import (
    ASPP, ConvBN, DeepLabV3)
from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
    load_variables

HW = (64, 128)                       # (H, W) of the model's input here
LOGIT_RTOL = 2e-4                    # of max |logit|
GRID = (4.0, 4.0, 0.2)
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "deeplab_synthetic.msgpack")
# bf16 labels of the port against the JAX bf16 engine on the module's two
# frames, measured on the CPU: seeded 0.9843 (deeplab) / 0.9824
# (deeplab_q), trained 0.99963 / 1.0; pinned as the earlier slices pinned
# theirs.
AGREE_BF16 = {"seeded": 0.98, "trained": 0.999}


@pytest.fixture(autouse=True)
def one_thread():
    """Long chains of small torch ops: one intra-op thread each, so that
    they do not stall on a host whose cores other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name, dtype="float32"):
    return dict(name=name, input_width=HW[1], input_height=HW[0],
                dtype=dtype)


@pytest.fixture(scope="module")
def trees():
    """The seeded tree and the trained checkpoint's (bf16 leaves as
    f32, the bits kept), and two synthetic road scenes at the model's
    size."""
    trained, cfg = load_variables(CKPT)
    assert cfg.name == "deeplab"
    rng = np.random.default_rng(4)
    frames = np.stack([jsynthetic.road_scene(rng, HW)[0] for _ in range(2)])
    return {"seeded": random_deeplab_variables(3),
            "trained": trained}, frames


@pytest.fixture(scope="module")
def jax_runs(trees):
    """JAX f32 logits, f32 grids (deeplab: cv2_linear; deeplab_q: the
    native grid) and bf16 labels, per (tree, engine)."""
    variables, frames = trees
    cal = toy_calibration(HW)
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    out = {}
    for which, v in variables.items():
        jv = jax.tree_util.tree_map(jnp.asarray, v)
        for name in ("deeplab", "deeplab_q"):
            interp = "native" if name == "deeplab_q" else "cv2_linear"
            e32 = jbuild(name, JModel(**_cfg(name)), variables=jv)
            pipe = JPipeline(e32, jcal, JGrid(*GRID), interpolation=interp)
            e16 = jbuild(name, JModel(**_cfg(name, "bfloat16")),
                         variables=jv)
            out[which, name] = (np.asarray(e32.logits(frames)),
                                np.stack([np.asarray(pipe(f))
                                          for f in frames]),
                                np.asarray(e16.logits(frames)).argmax(-1))
    return out


@pytest.mark.parametrize("name", ["deeplab", "deeplab_q"])
@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_logits_and_grids_equal_jax(trees, jax_runs, which, name):
    variables, frames = trees
    want, want_grids, _ = jax_runs[which, name]
    eng = port.build_engine(name, port.ModelConfig(**_cfg(name)),
                            variables=variables[which], device="cpu")
    got = eng.logits(frames).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())
    interp = "native" if name == "deeplab_q" else "cv2_linear"
    pipe = port.Pipeline(eng, toy_calibration(HW), port.GridConfig(*GRID),
                         interpolation=interp)
    assert pipe.builder.label_scale == (4 if name == "deeplab_q" else 1)
    np.testing.assert_array_equal(pipe.run_batch(frames).numpy(),
                                  want_grids)
    np.testing.assert_array_equal(
        np.stack([pipe(f).numpy() for f in frames]), want_grids)


@pytest.mark.parametrize("name", ["deeplab", "deeplab_q"])
@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_bf16_labels_pinned(trees, jax_runs, which, name):
    variables, frames = trees
    eng = port.build_engine(name, port.ModelConfig(**_cfg(name, "bfloat16")),
                            variables=variables[which], device="cpu")
    got = eng.logits(frames).argmax(-1).numpy()
    agree = float((got == jax_runs[which, name][2]).mean())
    assert agree >= AGREE_BF16[which], agree
    if which == "seeded":   # several classes win: the agreement counts
        share = np.bincount(got.ravel(), minlength=15) / got.size
        assert share.max() < 0.9, share


def test_bridge_is_strict(trees):
    variables, _ = trees
    v = variables["seeded"]
    sd = deeplab_state_dict(v)
    assert sd["ir2_0.depthwise.Conv_0.weight"].shape == (96, 1, 3, 3)
    assert sd["stem.Conv_0.weight"].shape == (32, 3, 3, 3)

    def edit(fn):
        tree = {"params": {k: dict(x) if isinstance(x, dict) else x
                           for k, x in v["params"].items()},
                "batch_stats": v["batch_stats"]}
        fn(tree["params"])
        return tree

    with pytest.raises(ValueError, match="unfilled"):
        deeplab_state_dict(edit(lambda p: p.pop("dec1")))
    with pytest.raises(ValueError, match="no place"):
        deeplab_state_dict(edit(lambda p: p.__setitem__(
            "extra", {"kernel": np.zeros((1, 1, 3, 4), np.float32)})))
    with pytest.raises(ValueError, match="shape"):
        deeplab_state_dict(edit(lambda p: p.__setitem__(
            "classifier", {"kernel": np.zeros((1, 1, 256, 15), np.float32),
                           "bias": np.zeros(14, np.float32)})))
    with pytest.raises(ValueError, match="MobileNetV2 DeepLab"):
        deeplab_state_dict({"params": {}})


def test_seeded_tree_is_deterministic_and_calibrated():
    a, b = random_deeplab_variables(5), random_deeplab_variables(5)
    np.testing.assert_array_equal(a["batch_stats"]["dec1"]["BatchNorm_0"]
                                  ["var"],
                                  b["batch_stats"]["dec1"]["BatchNorm_0"]
                                  ["var"])
    # the deep blocks keep their random statistics, the decoder's path
    # takes the calibration frame's
    assert not np.array_equal(
        a["batch_stats"]["stem"]["BatchNorm_0"]["var"],
        random_deeplab_variables(6)["batch_stats"]["stem"]["BatchNorm_0"]
        ["var"])
    var = a["batch_stats"]["ir7"]["depthwise"]["BatchNorm_0"]["var"]
    assert var.min() >= 0.5 and var.max() <= 1.5


def test_engine_grammar_and_defaults():
    for name, scale in (("deeplab", 1), ("deeplab_q", 4),
                        ("deeplab_q_w16", 4)):
        eng = port.build_engine(name, port.ModelConfig(**_cfg(
            name.replace("_w16", ""))), device="cpu")
        assert eng.family == "deeplab" and eng.label_scale == scale
        assert isinstance(eng.module, DeepLabV3)
        assert eng.weights_bf16 == name.endswith("_w16")
    with pytest.raises(ValueError, match="unknown model"):
        port.build_engine("deeplab_int8", device="cpu")
    # the JAX package's default size, 1024x512 (the module is not run)
    cfg = port.build_engine("deeplab", device="cpu").cfg
    assert (cfg.input_width, cfg.input_height, cfg.num_classes) == \
        (1024, 512, 15)


def test_blocks_and_checks():
    x = torch.linspace(-10, 10, 2 * 4 * 4 * 3).reshape(2, 4, 4, 3)
    relu6 = ConvBN(3, 3, 1, relu6=True)
    relu = ConvBN(3, 3, 1)                      # Xception's default
    linear = ConvBN(3, 3, 1, act=False)
    with torch.no_grad():
        for m in (relu6, relu, linear):
            m.Conv_0.weight.copy_(torch.eye(3).reshape(3, 3, 1, 1) * 4)
        assert float(relu6(x).max()) == 6.0 and float(relu6(x).min()) == 0
        assert float(relu(x).max()) > 6.0
        assert float(linear(x).min()) < 0.0
    assert ASPP(8).merge.relu6 is False and ASPP(8, relu6=True).b1.relu6
    with pytest.raises(ValueError, match="divisible by 16"):
        DeepLabV3()(torch.zeros(1, 24, 32, 3))
    with pytest.raises(ValueError, match="head_upsample"):
        DeepLabV3(head_upsample="half")
