"""The port's UNet (``models/unet.py``), its weight bridge
(``convert/flax_unet.py``) and its engines against the JAX package's, on
the same weights and the same numpy-made frames.

float32: logits within 2e-4 * max|logit| of the Flax stock UNet (measured
~1e-6 relative), grids equal; ``unet_ph`` (the JAX package's 2x2
phase-space layout, the same module in the port) against JAX ``unet_ph``
within the JAX package's own pinned budget of 0.1 % of labels, and
against JAX ``unet`` exactly as ``unet`` is held.  bf16 label agreement is
measured and pinned.  The 2x2 stride-2 transposed conv takes Flax's kernel
orientation; PyTorch's (the kernel unflipped) is a mirrored sub-pixel
pattern that a shape test would not see.
"""

import os

import flax.linen as fnn
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
from bugcar_image_segmentation_tpu.models.fastconv import FastConvTranspose2x
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_unet import (
    random_unet_variables, unet_state_dict)
from bugcar_image_segmentation_tpu_torch.models.unet import UNet, UpConv2x
from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
    load_variables

HW = (64, 128)
LOGIT_RTOL = 2e-4                    # of max |logit|
GRID = (4.0, 4.0, 0.2)
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "unet_synthetic.msgpack")
# bf16 labels of the port against the JAX bf16 engine on the module's two
# frames, measured on the CPU: seeded 0.99432, trained 1.0; pinned as the
# earlier slices pinned theirs (unet_ph's f32 labels: 0 flips against JAX
# unet_ph on both trees).
AGREE_BF16 = {"seeded": 0.98, "trained": 0.999}
PH_LABEL_BUDGET = 1e-3     # tests/test_unet_phase.py's unet vs unet_ph


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
    trained, cfg = load_variables(CKPT)
    assert cfg.name == "unet"
    rng = np.random.default_rng(6)
    frames = np.stack([jsynthetic.road_scene(rng, HW)[0] for _ in range(2)])
    return {"seeded": random_unet_variables(3), "trained": trained}, frames


@pytest.fixture(scope="module")
def jax_runs(trees):
    """Per tree: JAX f32 logits and grids of ``unet``, f32 labels of
    ``unet_ph``, bf16 labels of ``unet``."""
    variables, frames = trees
    jcal = JCal.from_reference_dict(toy_calibration(HW).to_reference_dict())
    out = {}
    for which, v in variables.items():
        jv = jax.tree_util.tree_map(jnp.asarray, v)
        e32 = jbuild("unet", JModel(**_cfg("unet")), variables=jv)
        pipe = JPipeline(e32, jcal, JGrid(*GRID))
        ph = jbuild("unet_ph", JModel(**_cfg("unet")), variables=jv)
        e16 = jbuild("unet", JModel(**_cfg("unet", "bfloat16")),
                     variables=jv)
        out[which] = (np.asarray(e32.logits(frames)),
                      np.stack([np.asarray(pipe(f)) for f in frames]),
                      np.asarray(ph.logits(frames)).argmax(-1),
                      np.asarray(e16.logits(frames)).argmax(-1))
    return out


@pytest.mark.parametrize("name", ["unet", "unet_ph"])
@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_logits_and_grids_equal_jax(trees, jax_runs, which, name):
    variables, frames = trees
    want, want_grids, ph_labels, _ = jax_runs[which]
    eng = port.build_engine(name, port.ModelConfig(**_cfg("unet")),
                            variables=variables[which], device="cpu")
    got = eng.logits(frames).numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_RTOL * np.abs(want).max())
    pipe = port.Pipeline(eng, toy_calibration(HW), port.GridConfig(*GRID))
    np.testing.assert_array_equal(pipe.run_batch(frames).numpy(),
                                  want_grids)
    if name == "unet_ph":   # against the JAX phase-space twin
        flips = float((got.argmax(-1) != ph_labels).mean())
        assert flips <= PH_LABEL_BUDGET, flips


@pytest.mark.parametrize("which", ["seeded", "trained"])
def test_bf16_labels_pinned(trees, jax_runs, which):
    variables, frames = trees
    eng = port.build_engine("unet", port.ModelConfig(**_cfg("unet",
                                                            "bfloat16")),
                            variables=variables[which], device="cpu")
    got = eng.logits(frames).argmax(-1).numpy()
    agree = float((got == jax_runs[which][3]).mean())
    assert agree >= AGREE_BF16[which], agree
    if which == "seeded":
        share = np.bincount(got.ravel(), minlength=15) / got.size
        assert share.max() < 0.9, share


def test_transposed_conv_takes_flax_orientation():
    """The port's 2x2 stride-2 up conv equals Flax's ConvTranspose and the
    JAX package's FastConvTranspose2x on the same kernel; the same kernel
    in PyTorch's orientation (unflipped) does not."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 7, 6)).astype(np.float32)
    kernel = rng.standard_normal((2, 2, 6, 4)).astype(np.float32)
    bias = rng.standard_normal(4).astype(np.float32)
    params = {"params": {"kernel": jnp.asarray(kernel),
                         "bias": jnp.asarray(bias)}}
    want = np.asarray(fnn.ConvTranspose(4, (2, 2), strides=(2, 2)).apply(
        params, jnp.asarray(x)))
    fast = np.asarray(FastConvTranspose2x(4, kernel=2, use_bias=True,
                                          dtype=jnp.float32).apply(
        params, jnp.asarray(x)))
    np.testing.assert_allclose(fast, want, rtol=1e-6, atol=1e-6)
    tree = {"params": {"up0": {"kernel": kernel, "bias": bias}}}
    up = UpConv2x(6, 4)
    with torch.no_grad():
        up.weight.copy_(torch.from_numpy(np.ascontiguousarray(
            np.flip(kernel, (0, 1)).transpose(2, 3, 0, 1))))
        up.bias.copy_(torch.from_numpy(bias))
        got = up(torch.from_numpy(x)).numpy()
        assert got.shape == (2, 10, 14, 4)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        up.weight.copy_(torch.from_numpy(kernel.transpose(2, 3, 0, 1)))
        assert np.abs(up(torch.from_numpy(x)).numpy() - want).max() > 0.1
    # and the bridge flips it
    from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
        strict_state_dict

    class One(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.up0 = UpConv2x(6, 4)

    sd = strict_state_dict(tree, One(), transposed=("up0",))
    np.testing.assert_array_equal(
        sd["up0.weight"].numpy(),
        np.flip(kernel, (0, 1)).transpose(2, 3, 0, 1))


def test_bridge_is_strict(trees):
    variables, _ = trees
    v = variables["seeded"]
    assert unet_state_dict(v)["up0.weight"].shape == (512, 256, 2, 2)

    def edit(fn):
        tree = {"params": dict(v["params"]),
                "batch_stats": v["batch_stats"]}
        fn(tree["params"])
        return tree

    with pytest.raises(ValueError, match="unfilled"):
        unet_state_dict(edit(lambda p: p.pop("up3")))
    with pytest.raises(ValueError, match="no place"):
        unet_state_dict(edit(lambda p: p.__setitem__(
            "enc4", {"conv0": {"kernel": np.zeros((3, 3, 3, 4),
                                                  np.float32)}})))
    with pytest.raises(ValueError, match="UNet"):
        unet_state_dict({"params": {}})


def test_engine_grammar_and_checks():
    for name in ("unet", "unet_ph", "unet_w16", "unet_ph_w16"):
        eng = port.build_engine(name, port.ModelConfig(**_cfg("unet")),
                                device="cpu")
        assert eng.family == "unet" and isinstance(eng.module, UNet)
        assert eng.frame_by_frame and eng.label_scale == 1
    cfg = port.build_engine("unet", device="cpu").cfg
    assert (cfg.input_width, cfg.input_height) == (512, 256)
    with pytest.raises(ValueError, match="divisible by 16"):
        UNet()(torch.zeros(1, 24, 32, 3))
