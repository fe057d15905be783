"""``bench.py``'s main path on the port against the JAX package:
``build_engine("enet_w16")`` and ``Pipeline(..., host_resize=True,
transport="i420")`` — the camera frame resized and packed as I420 on the
host, converted back on the device, ENet from bf16-rounded weights — and
``stream(..., transfer_batch=K)``.

A 128x64 ENet with seeded weights, fed 160x120 synthetic road frames (so
the host resize runs), a 20x20 grid:

- f32 activations (``ModelConfig(dtype="float32")``): the port's grids
  equal the JAX ``Pipeline``'s, per frame, batched and streamed, for
  ``enet_w16`` and ``enet_fused_w16`` (the fused trunk's plain version on
  the CPU) — the bf16 rounding of the weights and of ENet's BatchNorm
  folds is reproduced, not approximated;
- bf16 activations: the two frameworks round at other points, so labels
  agree on a measured share: 0.99004 of the pixels of the first 5 frames
  (pinned at 0.98);
- ``stream(transfer_batch=4)`` over 10 frames (a partial last batch)
  equals the per-frame grids;
- ``Pipeline.from_configs`` takes the warp mode and the default depth from
  a ``RuntimeConfig``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel,
                                                   RuntimeConfig as JRuntime)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import synthetic
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_xception import \
    random_xception_variables

pytest.importorskip("cv2")      # the JAX package's host resize and i420

HW = (64, 128)
CAMERA = (120, 160)
GRID = (4.0, 4.0, 0.2)
BENCH = dict(host_resize=True, transport="i420")
LABELS_BF16 = 0.98       # pinned; measured 0.99004


@pytest.fixture(scope="module")
def setup():
    v = random_enet_variables(13)
    cal = toy_calibration(HW)
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    frames = [f for f, _, _ in synthetic.video(seed=4, num_frames=10,
                                               shape=CAMERA)]
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    jeng = {dt: jbuild("enet_w16", JModel(dtype=dt, input_width=HW[1],
                                          input_height=HW[0]), variables=jv)
            for dt in ("float32", "bfloat16")}
    jpipe = JPipeline(jeng["float32"], jcal, JGrid(*GRID), **BENCH)
    want = np.stack([np.asarray(jpipe(f)) for f in frames])
    return dict(v=v, cal=cal, jcal=jcal, frames=frames, jeng=jeng,
                jpipe=jpipe, want=want)


def _pipe(s, name, dtype="float32", **kw):
    eng = port.build_engine(name, port.ModelConfig(
        name=name, dtype=dtype, input_width=HW[1], input_height=HW[0]),
        variables=s["v"], device="cpu")
    return port.Pipeline(eng, s["cal"], port.GridConfig(*GRID),
                         **(kw or BENCH))


@pytest.mark.parametrize("name", ["enet_w16", "enet_fused_w16"])
def test_f32_grids_equal_jax(setup, name):
    s = setup
    pipe = _pipe(s, name)
    single = np.stack([pipe(f).numpy() for f in s["frames"][:3]])
    assert single.dtype == np.int8 and single.shape == (3, 20, 20)
    assert {-1, 0, 100} >= set(np.unique(single).tolist())
    np.testing.assert_array_equal(single, s["want"][:3])
    np.testing.assert_array_equal(
        pipe.run_batch(np.stack(s["frames"])).numpy(), s["want"])


def test_stream_transfer_batch_equals_per_frame(setup):
    """K frames per host→device copy, the last batch partial (10 = 4 + 4
    + 2, padded with its last frame): the grids of the per-frame run (the
    JAX pipeline's, frame by frame), in order."""
    s = setup
    pipe = _pipe(s, "enet_w16")
    for k, depth, sync in ((4, 16, 16), (3, 1, 1), (1, 2, 3)):
        got = np.stack(list(pipe.stream(iter(s["frames"]), depth=depth,
                                        sync_chunk=sync, transfer_batch=k)))
        np.testing.assert_array_equal(got, s["want"])
    with pytest.raises(ValueError, match="transfer_batch"):
        list(pipe.stream(iter(s["frames"]), transfer_batch=0))


def test_bf16_labels_agree_with_jax(setup):
    s = setup
    pipe = _pipe(s, "enet_w16", "bfloat16")
    jpipe = JPipeline(s["jeng"]["bfloat16"], s["jcal"], JGrid(*GRID),
                      **BENCH)
    agree = []
    for f in s["frames"][:5]:
        grid, seg = pipe.segment_and_grid(f)
        jgrid, jseg = jpipe.segment_and_grid(f)
        assert grid.dtype == torch.int8 and grid.shape == (20, 20)
        agree.append(float((seg.numpy() == np.asarray(jseg)).mean()))
    assert np.mean(agree) >= LABELS_BF16, agree


def test_host_resize_bgr_equals_jax(setup):
    """The host resize alone (frames cross as BGR at model resolution)."""
    s = setup
    kw = dict(host_resize=True, transport="bgr")
    jp = JPipeline(s["jeng"]["float32"], s["jcal"], JGrid(*GRID), **kw)
    pipe = _pipe(s, "enet_w16", **kw)
    frames = s["frames"][:3]
    np.testing.assert_array_equal(
        pipe.run_batch(np.stack(frames)).numpy(),
        np.stack([np.asarray(jp(f)) for f in frames]))


def test_from_configs(setup):
    s = setup
    runtime = port.RuntimeConfig(pipeline_depth=3,
                                 warp_interpolation="nearest")
    pipe = port.Pipeline.from_configs(
        _pipe(s, "enet_w16").engine, s["cal"], port.GridConfig(*GRID),
        runtime, **BENCH)
    jp = JPipeline.from_configs(
        s["jeng"]["float32"], s["jcal"], JGrid(*GRID),
        JRuntime(pipeline_depth=3, warp_interpolation="nearest"), **BENCH)
    assert pipe.default_depth == jp.default_depth == 3
    assert pipe.builder.interpolation == "nearest"
    frames = s["frames"][:3]
    np.testing.assert_array_equal(
        np.stack(list(pipe.stream(iter(frames)))),
        np.stack([np.asarray(jp(f)) for f in frames]))
    override = port.Pipeline.from_configs(
        pipe.engine, s["cal"], port.GridConfig(*GRID), runtime,
        interpolation="cv2_linear", **BENCH)
    assert override.builder.interpolation == "cv2_linear"


def test_w16_names_build_and_round_the_weights():
    """``_w16`` on each family: the weights hold bf16 values; the name
    grammar is kept (Xception with 2 middle blocks, to stay small)."""
    small_xception = random_xception_variables(0, middle_blocks=2)
    for name, mcfg, v in (
            ("enet_fused_w16", dict(input_width=64, input_height=32), None),
            ("segformer_b0_w16", dict(input_width=64, input_height=64),
             None),
            ("xception_fs_w16", dict(input_width=64, input_height=64),
             small_xception)):
        eng = port.build_engine(name, port.ModelConfig(
            name=name, dtype="float32", **mcfg), variables=v, device="cpu")
        assert eng.weights_bf16
        for t in eng.module.parameters():
            np.testing.assert_array_equal(
                t.detach(), t.detach().to(torch.bfloat16).float())
        frame = np.zeros((mcfg["input_height"], mcfg["input_width"], 3),
                         np.uint8)
        assert eng.predict(frame).shape == (mcfg["input_height"],
                                            mcfg["input_width"])
    with pytest.raises(ValueError, match="_w16"):
        port.build_engine("fcn_w16", device="cpu")
