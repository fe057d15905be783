"""The port's contour filter and CLAHE (``postproc.py``) against the JAX
package's, on seeded masks and frames.

Connected components, hole filling and the contour filter are integer
fixed points: bit-equal, on a spiral too, whose one component needs
hundreds of propagation steps, and whatever the steps between the port's
convergence checks.  CLAHE computes in float: the tile LUTs are bit-equal,
but XLA compiles the float32 arithmetic around them otherwise than torch
runs it -- its ``pow`` (the sRGB curve, the cube root of L*) differs in
the last bit on ~1.4 % of pixels, and inside one jitted function it folds
the tile coordinates and the bilinear blend into other float steps (the
tile fractions differ in the last bit on ~13 % of rows and columns) --
so a blended value near a rounding tie lands on the other byte: the share
of equal bytes is measured and pinned.  ``Pipeline(use_clahe=True,
contour_filter=True)`` grids are held against the JAX pipeline's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import postproc as jpost
from bugcar_image_segmentation_tpu import synthetic as jsynthetic
from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import postproc
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables

# Equal bytes, port vs JAX, on the three 240x320 synthetic frames below,
# measured on the CPU: CLAHE 0.99956, the L channel's CLAHE given the same
# L 0.99943 (within 3 and 2); the pipeline test's segmentation map 0.99939
# (5 of 8192 labels, its grids equal); pinned at 0.999.
CLAHE_EQUAL = 0.999


@pytest.fixture(autouse=True)
def one_thread():
    """Long chains of small torch ops: one intra-op thread each, so that
    they do not stall on a host whose cores other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _spiral(n: int) -> np.ndarray:
    """One 1-pixel-wide corridor winding inwards, arms two rows apart."""
    s = np.zeros((n, n), np.uint8)
    x0 = y0 = 0
    x1 = y1 = n - 1
    while x0 <= x1 and y0 <= y1:
        s[y0, x0:x1 + 1] = 1
        s[y0:y1 + 1, x1] = 1
        s[y1, x0:x1 + 1] = 1
        if y0 + 2 <= y1:
            s[y0 + 2:y1 + 1, x0] = 1
            s[y0 + 2, x0:x0 + 2] = 1
        x0, y0, x1, y1 = x0 + 2, y0 + 2, x1 - 2, y1 - 2
    return s


@pytest.fixture(scope="module")
def masks():
    rng = np.random.default_rng(0)
    m = [(rng.random((48, 96)) < p).astype(np.uint8) for p in (0.3, 0.55)]
    road = np.zeros((64, 128), np.uint8)
    road[30:, 20:110] = 1
    road[34:40, 60:70] = 0                       # a hole
    road[5:15, 5:20] = 1                         # an island off the strip
    spiral = np.zeros((48, 96), np.uint8)
    spiral[:, :48] = _spiral(48)
    return m + [road[:48, :96], spiral]


@pytest.mark.parametrize("every", [1, 5, postproc.CHECK_EVERY])
def test_label_components_equal_jax(masks, monkeypatch, every):
    monkeypatch.setattr(postproc, "CHECK_EVERY", every)
    for m in masks:
        got = postproc.label_components(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jpost.label_components(jnp.asarray(m))))
    spiral = postproc.label_components(torch.from_numpy(masks[-1]))
    assert set(np.unique(spiral.numpy()).tolist()) == {0, 1}
    batch = postproc.label_components(torch.from_numpy(np.stack(masks)))
    for i, m in enumerate(masks):
        np.testing.assert_array_equal(batch[i].numpy(), np.asarray(
            jpost.label_components(jnp.asarray(m))))


def test_fill_holes_and_contour_filter_equal_jax(masks):
    stack = torch.from_numpy(np.stack(masks))
    filled = postproc.fill_holes(stack).numpy()
    kept = postproc.contour_noise_removal(stack).numpy()
    strip = postproc.keep_components_by_strip_overlap(stack).numpy()
    for i, m in enumerate(masks):
        jm = jnp.asarray(m)
        np.testing.assert_array_equal(filled[i],
                                      np.asarray(jpost.fill_holes(jm)))
        np.testing.assert_array_equal(
            kept[i], np.asarray(jpost.contour_noise_removal(jm)))
        np.testing.assert_array_equal(strip[i], np.asarray(
            jpost.keep_components_by_strip_overlap(jm)))
    road = kept[2]
    assert road[34:40, 60:70].all() and not road[5:15, 5:20].any()


def test_clahe_equal_jax_on_a_pinned_share():
    frames = np.stack([f for f, _, _ in jsynthetic.video(
        seed=3, num_frames=3, shape=(240, 320))])
    got = postproc.clahe(torch.from_numpy(frames)).numpy()
    want = np.stack([np.asarray(jpost.clahe(jnp.asarray(f)))
                     for f in frames])
    assert got.dtype == np.uint8 and got.shape == frames.shape
    assert float((got == want).mean()) >= CLAHE_EQUAL
    assert np.abs(got.astype(int) - want).max() <= 3
    # given the same L: the tile LUTs exact, the blend on the pinned share
    l_u8 = np.stack([np.clip(np.round(np.asarray(jpost.bgr_to_lab_l(
        jnp.asarray(f)))), 0, 255).astype(np.uint8) for f in frames])
    np.testing.assert_array_equal(
        postproc._tile_luts(torch.from_numpy(l_u8), (8, 8), 3.0).numpy(),
        np.stack([np.asarray(jpost._tile_luts(jnp.asarray(x), (8, 8), 3.0))
                  for x in l_u8]))
    got_l = postproc.clahe_l_channel(torch.from_numpy(l_u8)).numpy()
    want_l = np.stack([np.asarray(jpost.clahe_l_channel(jnp.asarray(x)))
                       for x in l_u8])
    assert float((got_l == want_l).mean()) >= CLAHE_EQUAL
    assert np.abs(got_l.astype(int) - want_l).max() <= 2
    lab = postproc.bgr_to_lab_l(torch.from_numpy(frames)).numpy()
    np.testing.assert_allclose(lab, np.stack([np.asarray(
        jpost.bgr_to_lab_l(jnp.asarray(f))) for f in frames]), atol=1e-4)


@pytest.mark.parametrize("mode", ["multiclass", "binary"])
def test_pipeline_clahe_and_contour_filter_equal_jax(mode):
    v = random_enet_variables(12)
    model = dict(input_width=128, input_height=64, dtype="float32")
    cal = toy_calibration((64, 128))
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    grid = (4.0, 4.0, 0.2)
    kw = dict(mode=mode, use_clahe=True, contour_filter=True)
    jpipe = JPipeline(jbuild("enet", JModel(**model),
                             variables=jax.tree_util.tree_map(jnp.asarray,
                                                              v)),
                      jcal, JGrid(*grid), **kw)
    eng = port.build_engine("enet", port.ModelConfig(**model), variables=v,
                            device="cpu")
    pipe = port.Pipeline(eng, cal, port.GridConfig(*grid), **kw)
    frames = [f for f, _, _ in jsynthetic.video(seed=4, num_frames=3,
                                                 shape=(96, 192))]
    want = np.stack([np.asarray(jpipe(f)) for f in frames])
    np.testing.assert_array_equal(np.stack([pipe(f).numpy()
                                            for f in frames]), want)
    np.testing.assert_array_equal(pipe.run_batch(np.stack(frames)).numpy(),
                                  want)
    _, seg = pipe.segment_and_grid(frames[0])
    _, jseg = jpipe.segment_and_grid(frames[0])
    assert float((seg.numpy() == np.asarray(jseg)).mean()) >= CLAHE_EQUAL
