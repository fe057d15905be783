"""The port's grid path against the JAX package, bit for bit.

Host plans (``perspective_taps``, ``cell_center_taps``) must give
identical index and weight arrays; the device side (``apply_warp``,
erode/dilate/``morph_open``, the resamplers, the remap) and
``OccupancyGridBuilder.build`` must give identical outputs on random
segmentation maps, multiclass and binary, single and batched.  Inputs are
made with numpy from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import geometry as jgeometry
from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid)
from bugcar_image_segmentation_tpu.grid import OccupancyGridBuilder as JB
from bugcar_image_segmentation_tpu.grid import \
    template_geometry as jtemplate_geometry
from bugcar_image_segmentation_tpu.models import preprocess as jpre
from bugcar_image_segmentation_tpu.models import remap as jremap
from bugcar_image_segmentation_tpu.ops import morphology as jmorph
from bugcar_image_segmentation_tpu.ops import pooling as jpooling
from bugcar_image_segmentation_tpu.ops import resize as jresize
from bugcar_image_segmentation_tpu.ops import warp as jwarp
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.configs import (CalibrationConfig,
                                                         GridConfig)
from bugcar_image_segmentation_tpu_torch.grid import (OccupancyGridBuilder,
                                                      template_geometry)
from bugcar_image_segmentation_tpu_torch.models import preprocess as tpre
from bugcar_image_segmentation_tpu_torch.models import remap as tremap
from bugcar_image_segmentation_tpu_torch.ops import morphology as tmorph
from bugcar_image_segmentation_tpu_torch.ops import pooling as tpooling
from bugcar_image_segmentation_tpu_torch.ops import resize as tresize
from bugcar_image_segmentation_tpu_torch.ops import warp as twarp

# (input (h, w), grid (width_m, height_m, cell_m)): the main path's
# geometry and a small one.
GEOMS = [((256, 512), (8.0, 8.0, 0.1)), ((32, 64), (4.0, 4.0, 0.2))]
INTERPS = ["cv2_linear", "nearest", "native"]


def _cals(hw):
    cal = toy_calibration(hw)
    return cal, JCal.from_reference_dict(cal.to_reference_dict())


def _segmaps(rng, n, h, w, classes):
    """Noise maps and blocky maps (large regions, like real labels)."""
    noise = rng.integers(0, classes, (n, h, w), dtype=np.uint8)
    blocks = np.repeat(np.repeat(
        rng.integers(0, classes, (n, h // 8, w // 8), dtype=np.uint8), 8,
        1), 8, 2)
    return np.concatenate([noise, blocks])


def test_toy_calibration_matches_the_jax_repo_numbers():
    from bugcar_image_segmentation_tpu.configs import CalibrationConfig
    h, w = 256, 512
    tile = np.array([[0.41 * w, 0.55 * h], [0.59 * w, 0.55 * h],
                     [0.64 * w, 0.72 * h], [0.36 * w, 0.73 * h]])
    ref = CalibrationConfig(input_shape=(w, h), output_shape=(256, 256),
                            dist2target=(2.0, 60.0), tile_length=60.0,
                            cm_per_px=2.0, yaw=0.05)
    m = jgeometry.calculate_transform_matrix(
        tile, output_shape=ref.output_shape, dist2target=ref.dist2target,
        tile_length=ref.tile_length, cm_per_px=ref.cm_per_px, yaw=ref.yaw)
    got = toy_calibration((h, w))
    assert got.to_reference_dict() == ref.with_matrix(m).to_reference_dict()


@pytest.mark.parametrize("hw,g", GEOMS)
def test_template_geometry_matches(hw, g):
    cal, jcal = _cals(hw)
    assert (tuple(template_geometry(cal, GridConfig(*g)))
            == tuple(jtemplate_geometry(jcal, JGrid(*g))))


@pytest.mark.parametrize("interp", ["cv2_linear", "nearest"])
@pytest.mark.parametrize("hw,g", GEOMS)
def test_perspective_taps_identical(hw, g, interp):
    cal, jcal = _cals(hw)
    geom = template_geometry(cal, GridConfig(*g))
    kw = dict(src_shape=hw, dst_shape=(geom.tpl_h, geom.tpl_w),
              interpolation=interp, dst_offset=geom.coord_offset,
              valid_rect=geom.valid_rect)
    a = jwarp.perspective_taps(jcal.matrix_np(), **kw)
    b = twarp.perspective_taps(cal.matrix_np(), **kw)
    assert b.indices.dtype == np.int32 and b.weights.dtype == np.float32
    np.testing.assert_array_equal(b.indices, np.asarray(a.indices))
    np.testing.assert_array_equal(b.weights, np.asarray(a.weights))
    assert (b.src_shape, b.mode) == (a.src_shape, a.mode)


@pytest.mark.parametrize("src_scale", [1, 4])
@pytest.mark.parametrize("interp", ["cv2_linear", "nearest"])
def test_cell_center_taps_identical(interp, src_scale):
    hw, g = GEOMS[0]
    cal, jcal = _cals(hw)
    geom = template_geometry(cal, GridConfig(*g))
    kw = dict(src_shape=hw, tpl_shape=(geom.tpl_h, geom.tpl_w),
              cells_shape=(geom.cells_h, geom.cells_w),
              dst_offset=geom.coord_offset, valid_rect=geom.valid_rect,
              interpolation=interp, src_scale=src_scale)
    a = jwarp.cell_center_taps(jcal.matrix_np(), **kw)
    b = twarp.cell_center_taps(cal.matrix_np(), **kw)
    np.testing.assert_array_equal(b.indices, np.asarray(a.indices))
    np.testing.assert_array_equal(b.weights, np.asarray(a.weights))
    assert b.src_shape == a.src_shape


def test_inverse_coords_identical():
    cal, jcal = _cals((256, 512))
    for off in ((0, 0), (-72, 56)):
        a = jwarp.cv2_inverse_coords(jcal.matrix_np(), 400, 300, off)
        b = twarp.cv2_inverse_coords(cal.matrix_np(), 400, 300, off)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("interp", ["cv2_linear", "nearest"])
def test_apply_warp_bit_equal(interp):
    hw, g = GEOMS[0]
    cal, jcal = _cals(hw)
    geom = template_geometry(cal, GridConfig(*g))
    kw = dict(src_shape=hw, dst_shape=(geom.tpl_h, geom.tpl_w),
              interpolation=interp, dst_offset=geom.coord_offset,
              valid_rect=geom.valid_rect)
    jt = jwarp.perspective_taps(jcal.matrix_np(), **kw)
    tt = twarp.taps_to(twarp.perspective_taps(cal.matrix_np(), **kw), "cpu")
    rng = np.random.default_rng(0)
    # labels + 1 (the builder's shift) and full-range u8 values
    srcs = list(_segmaps(rng, 2, *hw, 3) + 1) + [
        rng.integers(0, 256, hw, dtype=np.uint8)]
    for src in srcs:
        a = np.asarray(jwarp.apply_warp(jnp.asarray(src), jt))
        b = twarp.apply_warp(torch.from_numpy(src), tt).numpy()
        assert b.dtype == np.uint8
        np.testing.assert_array_equal(b, a)
    batch = np.stack(srcs)
    np.testing.assert_array_equal(
        twarp.apply_warp(torch.from_numpy(batch), tt).numpy(),
        np.stack([np.asarray(jwarp.apply_warp(jnp.asarray(s), jt))
                  for s in srcs]))


def test_pack_neighborhood_bit_equal():
    src = np.random.default_rng(1).integers(0, 256, (7, 9), dtype=np.uint8)
    np.testing.assert_array_equal(
        twarp.pack_neighborhood(torch.from_numpy(src)).numpy(),
        np.asarray(jwarp.pack_neighborhood(jnp.asarray(src))))


@pytest.mark.parametrize("op", ["erode", "dilate", "morph_open"])
@pytest.mark.parametrize("dtype,ksize", [(np.uint8, (3, 3)),
                                         (np.uint8, (5, 3)),
                                         (np.float32, (3, 3))])
def test_morphology_bit_equal(op, dtype, ksize):
    rng = np.random.default_rng(2)
    x = (rng.integers(0, 2, (2, 31, 40)) if dtype == np.uint8
         else rng.standard_normal((2, 31, 40))).astype(dtype)
    a = np.asarray(getattr(jmorph, op)(jnp.asarray(x), ksize))
    b = getattr(tmorph, op)(torch.from_numpy(x), ksize).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("mode", ["multiclass", "binary"])
@pytest.mark.parametrize("interp", INTERPS)
@pytest.mark.parametrize("hw,g", GEOMS)
def test_builder_bit_equal(hw, g, interp, mode):
    cal, jcal = _cals(hw)
    jb = JB(jcal, JGrid(*g), mode=mode, interpolation=interp)
    tb = OccupancyGridBuilder(cal, GridConfig(*g), mode=mode,
                              interpolation=interp, device="cpu")
    rng = np.random.default_rng(3)
    segs = _segmaps(rng, 2, *hw, 3 if mode == "multiclass" else 2)
    want = np.stack([np.asarray(jb(s)) for s in segs])
    got = tb(segs).numpy()
    assert got.dtype == np.int8
    assert got.shape == (len(segs), GridConfig(*g).cells_h,
                         GridConfig(*g).cells_w)
    assert set(np.unique(got).tolist()) <= {-1, 0, 100}
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tb(segs[0]).numpy(), want[0])


def test_builder_rejects_what_this_slice_lacks():
    cal, _ = _cals((32, 64))
    with pytest.raises(ValueError, match="requires interpolation='native'"):
        OccupancyGridBuilder(cal, GridConfig(4.0, 4.0, 0.2), label_scale=4,
                             device="cpu")
    with pytest.raises(ValueError, match="unknown mode"):
        OccupancyGridBuilder(cal, GridConfig(4.0, 4.0, 0.2), mode="polar",
                             device="cpu")
    with pytest.raises(ValueError, match="segmap shape"):
        OccupancyGridBuilder(cal, GridConfig(4.0, 4.0, 0.2),
                             device="cpu")(np.zeros((16, 16), np.uint8))


def test_resamplers_match():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (2, 3, 48, 96)).astype(np.float32)
    np.testing.assert_array_equal(
        tresize.resize_bilinear(torch.from_numpy(img), (32, 64)).numpy(),
        np.asarray(jresize.resize_bilinear(jnp.asarray(img), (32, 64))))
    lab = rng.integers(0, 15, (2, 37, 53), dtype=np.uint8)
    for dst in ((20, 20), (80, 80), (11, 97)):
        np.testing.assert_array_equal(
            tresize.resize_nearest(torch.from_numpy(lab), dst).numpy(),
            np.asarray(jresize.resize_nearest(jnp.asarray(lab), dst)))
    np.testing.assert_array_equal(
        tresize.upsample_nearest_int(torch.from_numpy(lab), 4).numpy(),
        np.asarray(jresize.upsample_nearest_int(jnp.asarray(lab), 4)))


def test_max_pool_2x2_matches():
    x = np.random.default_rng(5).standard_normal((2, 8, 6, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tpooling.max_pool_2x2(torch.from_numpy(x)).numpy(),
        np.asarray(jpooling.max_pool_2x2(jnp.asarray(x))))


def test_preprocess_matches():
    """Resize + BGR→RGB + /256 + ImageNet normalise, f32 (the same
    arithmetic; rtol 1e-6 allows XLA's fused multiply-adds)."""
    frames = np.random.default_rng(6).integers(0, 256, (2, 48, 96, 3),
                                               np.uint8)
    for hw in ((32, 64), (48, 96)):
        a = np.asarray(jpre.preprocess_frame(jnp.asarray(frames), hw,
                                             dtype=jnp.float32))
        b = tpre.preprocess_frame(torch.from_numpy(frames), hw,
                                  dtype=torch.float32).numpy()
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)


def test_remap_matches():
    rng = np.random.default_rng(7)
    logits = rng.standard_normal((2, 9, 11, 15)).astype(np.float32)
    np.testing.assert_array_equal(tremap.remap_table(),
                                  jremap.remap_table())
    np.testing.assert_array_equal(
        tremap.logits_to_drivability(torch.from_numpy(logits)).numpy(),
        np.asarray(jremap.logits_to_drivability(jnp.asarray(logits))))
    np.testing.assert_array_equal(
        tremap.logits_to_binary_road(torch.from_numpy(logits)).numpy(),
        np.asarray(jremap.logits_to_binary_road(jnp.asarray(logits))))
    classes = rng.integers(0, 15, (5, 7))
    np.testing.assert_array_equal(
        tremap.remap_classes(torch.from_numpy(classes)).numpy(),
        np.asarray(jremap.remap_classes(jnp.asarray(classes))))
