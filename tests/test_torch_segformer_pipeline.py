"""The port's SegFormer engines (``build_engine("segformer_b0[_q]")``),
the quarter-resolution grid (``OccupancyGridBuilder(label_scale=4)``) and
``Pipeline`` against the JAX package, on the same seeded weights and the
same numpy-made frames.

Float32: logits rtol = atol = 1e-4, labels and grids equal (the measured
logit gap, ~3e-6, leaves no argmax near-tie on these frames).  bfloat16:
labels agree with the JAX bf16 engine on >= 0.98 of pixels (measured
0.9917 / 0.9922 for segformer_b0 / _q on seeded random weights at 64x64;
0.99997 on the trained checkpoint, tests/test_torch_segformer.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.grid import \
    OccupancyGridBuilder as JBuilder
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
    random_segformer_variables
from bugcar_image_segmentation_tpu_torch.models.api import (
    frames_to_device, segformer_variant)

RTOL = ATOL = 1e-4
AGREE_BF16 = 0.98
GRID = (4.0, 4.0, 0.2)
HW = (64, 64)


def _cfg(name, dtype="float32"):
    return dict(name=name, input_width=HW[1], input_height=HW[0],
                dtype=dtype)


@pytest.fixture(scope="module")
def ref():
    """JAX engines (f32 and bf16) for segformer_b0 and segformer_b0_q on
    one seeded tree, and their outputs on four 96x48 frames: logits,
    labels, and the JAX Pipeline's grids (default warp for b0, the native
    grid for _q)."""
    v = random_segformer_variables(3)
    jv = jax.tree_util.tree_map(jnp.asarray, v)
    frames = np.random.default_rng(1).integers(0, 256, (4, 48, 96, 3),
                                               np.uint8)
    cal = toy_calibration(HW)
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    out = {}
    for name, interp in (("segformer_b0", "cv2_linear"),
                         ("segformer_b0_q", "native")):
        j32 = jbuild(name, JModel(**_cfg(name)), variables=jv)
        j16 = jbuild(name, JModel(**_cfg(name, "bfloat16")), variables=jv)
        jpipe = JPipeline(j32, jcal, JGrid(*GRID), interpolation=interp)
        out[name] = dict(
            logits=np.asarray(j32.logits(frames)),
            labels=np.asarray(j32.predict(frames)),
            labels16=np.asarray(j16.predict(frames)),
            grids=np.stack([np.asarray(jpipe(f)) for f in frames]),
            interp=interp, label_scale=j32.label_scale)
    return v, frames, cal, out


@pytest.mark.parametrize("name", ["segformer_b0", "segformer_b0_q"])
def test_engine_f32_matches_jax(ref, name):
    v, frames, _, out = ref
    r = out[name]
    eng = port.build_engine(name, port.ModelConfig(**_cfg(name)),
                            variables=v, device="cpu")
    assert eng.label_scale == r["label_scale"]
    side = HW[0] // eng.label_scale
    logits = eng.logits(frames).numpy()
    assert logits.shape == (4, side, side, 15)
    np.testing.assert_allclose(logits, r["logits"], rtol=RTOL, atol=ATOL)
    labels = eng.predict(frames).numpy()
    assert labels.dtype == np.uint8 and labels.shape == (4, *HW)
    np.testing.assert_array_equal(labels, r["labels"])
    road = np.isin(logits.argmax(-1), (0, 1)).astype(np.uint8)
    np.testing.assert_array_equal(eng.segment_head(
        frames_to_device(frames, "cpu"), "binary").numpy(), road)
    np.testing.assert_array_equal(eng.predict(frames[0]).numpy(), labels[0])


@pytest.mark.parametrize("name", ["segformer_b0", "segformer_b0_q"])
def test_engine_bf16_label_agreement_budget(ref, name):
    v, frames, _, out = ref
    eng = port.build_engine(name, port.ModelConfig(**_cfg(name, "bfloat16")),
                            variables=v, device="cpu")
    agree = float((eng.predict(frames).numpy()
                   == out[name]["labels16"]).mean())
    assert agree >= AGREE_BF16, agree


@pytest.mark.parametrize("name", ["segformer_b0", "segformer_b0_q"])
def test_pipeline_grids_equal_jax(ref, name):
    """Grids bit-equal to the JAX Pipeline's, f32, for __call__, batched
    runs and stream; _q through the native grid reads the quarter-res
    labels directly (label_scale 4)."""
    v, frames, cal, out = ref
    r = out[name]
    eng = port.build_engine(name, port.ModelConfig(**_cfg(name)),
                            variables=v, device="cpu")
    pipe = port.Pipeline(eng, cal, port.GridConfig(*GRID),
                         interpolation=r["interp"])
    assert pipe.builder.label_scale == r["label_scale"]
    want = r["grids"]
    single = np.stack([pipe(f).numpy() for f in frames])
    assert single.dtype == np.int8 and single.shape == (4, 20, 20)
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(pipe.run_batch(frames).numpy(), want)
    np.testing.assert_array_equal(
        np.stack(list(pipe.stream(iter(frames), depth=2))), want)
    grid, seg = pipe.segment_and_grid(frames[1])
    np.testing.assert_array_equal(grid.numpy(), want[1])
    np.testing.assert_array_equal(seg.numpy(), r["labels"][1])


def test_quarter_engine_through_the_default_grid(ref):
    """_q with the parity warp: the labels are lifted to input res first,
    as the JAX Pipeline does."""
    v, frames, cal, _ = ref
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    jeng = jbuild("segformer_b0_q", JModel(**_cfg("segformer_b0_q")),
                  variables=jax.tree_util.tree_map(jnp.asarray, v))
    want = np.asarray(JPipeline(jeng, jcal, JGrid(*GRID))(frames[2]))
    eng = port.build_engine("segformer_b0_q",
                            port.ModelConfig(**_cfg("segformer_b0_q")),
                            variables=v, device="cpu")
    pipe = port.Pipeline(eng, cal, port.GridConfig(*GRID))
    assert pipe.builder.label_scale == 1
    np.testing.assert_array_equal(pipe(frames[2]).numpy(), want)


@pytest.mark.parametrize("mode", ["multiclass", "binary"])
def test_label_scale_grid_equals_jax_builder(mode):
    """OccupancyGridBuilder(label_scale=4, interpolation="native") on a
    quarter-res map: bit-equal to the JAX builder."""
    cal = toy_calibration((128, 256))
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    top = 3 if mode == "multiclass" else 2
    seg = np.random.default_rng(5).integers(0, top, (3, 32, 64), np.uint8)
    kw = dict(mode=mode, interpolation="native", label_scale=4)
    jb = JBuilder(jcal, JGrid(8.0, 8.0, 0.1), **kw)
    b = port.OccupancyGridBuilder(cal, port.GridConfig(8.0, 8.0, 0.1),
                                  device="cpu", **kw)
    assert b.segmap_shape == (32, 64)
    np.testing.assert_array_equal(
        b(seg).numpy(), np.stack([np.asarray(jb.build(s)) for s in seg]))
    with pytest.raises(ValueError, match="segmap shape"):
        b(np.zeros((128, 256), np.uint8))
    with pytest.raises(ValueError, match="native"):
        port.OccupancyGridBuilder(cal, port.GridConfig(8.0, 8.0, 0.1),
                                  label_scale=4, device="cpu")


def test_engine_names_and_defaults():
    eng = port.build_engine("segformer_b1_q",
                            port.ModelConfig(**_cfg("segformer_b1_q")),
                            device="cpu", seed=4)
    assert eng.size == "b1" and eng.label_scale == 4
    assert eng.module.embed0.Conv_0.weight.shape[0] == 64
    frames = np.zeros((2, 48, 96, 3), np.uint8)
    assert tuple(eng.segment_head(frames_to_device(frames, "cpu")).shape) \
        == (2, 16, 16)
    assert tuple(eng.predict(frames).shape) == (2, 64, 64)
    # self-initialised engines are seeded
    a = port.build_engine("segformer", port.ModelConfig(**_cfg("segformer")),
                          device="cpu", seed=4)
    b = port.build_engine("segformer_b0",
                          port.ModelConfig(**_cfg("segformer_b0")),
                          device="cpu", seed=4)
    np.testing.assert_array_equal(a.logits(frames[0]).numpy(),
                                  b.logits(frames[0]).numpy())


def test_default_config_and_unported_variants():
    eng = port.build_engine("segformer_b0", device="cpu")
    assert (eng.cfg.input_width, eng.cfg.input_height,
            eng.cfg.num_classes) == (1024, 1024, 15)
    # (size, quarter head, int8, head cascade), flags in any order
    assert segformer_variant("segformer") == ("b0", False, False, False)
    assert segformer_variant("segformer_q_b2") == ("b2", True, False, False)
    assert segformer_variant("segformer_b3") == ("b3", False, False, False)
    for name, want in (("segformer_int8", ("b0", False, True, False)),
                       ("segformer_b0_hc", ("b0", False, False, True)),
                       ("segformer_b2_q_int8", ("b2", True, True, False)),
                       ("segformer_hc_q_b2", ("b2", True, False, True))):
        assert segformer_variant(name) == want
    # the flags reach the module (the variants' numbers:
    # tests/test_torch_segformer_variants.py)
    eng = port.build_engine("segformer_hc_int8", device="cpu")
    assert (eng.size, eng.int8, eng.cascade) == ("b0", True, True)
    assert eng.module.quant and eng.module.head_cascade
    for name in ("segformer_b9", "segformer_b0_b1", "segformer_int4"):
        with pytest.raises(ValueError, match="unknown SegFormer"):
            port.build_engine(name, device="cpu")
