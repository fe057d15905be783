"""The port's polar plans and laserscan grids (``ops/polar.py``,
``grid.py``) against the JAX package's, bit for bit: cv2's fastAtan2
polynomial in float32, the forward and inverse gather plans, multiclass
and binary laserscan grids (singly and batched), and ``Pipeline``'s binary
laserscan pair stacked to (2, H, W) so that streaming still works
(mirroring the JAX package's tests/test_pipeline_eval.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid)
from bugcar_image_segmentation_tpu.grid import OccupancyGridBuilder as JB
from bugcar_image_segmentation_tpu.ops import polar as jpolar
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables
from bugcar_image_segmentation_tpu_torch.grid import OccupancyGridBuilder
from bugcar_image_segmentation_tpu_torch.ops import polar

GRIDS = [(4.0, 4.0, 0.2), (8.0, 6.0, 0.1)]


@pytest.fixture(autouse=True)
def one_thread():
    """Long chains of small torch ops: one intra-op thread each, so that
    they do not stall on a host whose cores other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_fast_atan2_bit_equal_with_octant_boundaries():
    rng = np.random.default_rng(0)
    pts = [(0.0, 0.0), (1.0, 0.0), (0.0, 1.0), (-1.0, 0.0), (0.0, -1.0)]
    for a in (1.0, -1.0):
        for b in (1.0, -1.0):
            pts += [(a, b), (a * 3, b * 3), (a, b * (1 + 1e-7)),
                    (a * (1 + 1e-7), b), (a * 1e-30, b), (a, b * 1e-30)]
    y, x = np.array(pts, np.float32).T
    y = np.concatenate([y, rng.uniform(-50, 50, 4000).astype(np.float32),
                        np.float32(np.arange(-40, 41))])
    x = np.concatenate([x, rng.uniform(-50, 50, 4000).astype(np.float32),
                        np.float32(np.arange(40, -41, -1))])
    got = polar.fast_atan2_deg(y, x)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32),
                                  jpolar.fast_atan2_deg(y, x).view(np.int32))


@pytest.mark.parametrize("longer", [20.0, 80.0])
def test_polar_plans_equal_jax(longer):
    cw = ch = int(longer)
    centre = (cw / 2 - 1, float(ch))
    for dsize in (polar.auto_polar_dsize(longer), (cw, ch), (-1, -1)):
        got = polar.polar_maps((ch, cw), dsize, centre, longer)
        want = jpolar.polar_maps((ch, cw), dsize, centre, longer)
        np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
        np.testing.assert_array_equal(got.valid, np.asarray(want.valid))
    pw, ph = polar.auto_polar_dsize(longer)
    got = polar.inverse_polar_maps((ch, cw), (ph, pw), centre, longer)
    want = jpolar.inverse_polar_maps((ch, cw), (ph, pw), centre, longer)
    np.testing.assert_array_equal(got.indices, np.asarray(want.indices))
    np.testing.assert_array_equal(got.valid, np.asarray(want.valid))


def test_first_hit_and_splat_equal_jax():
    rng = np.random.default_rng(1)
    img = rng.choice(np.array([0, 1, 3], np.uint8), (3, 40, 25),
                     p=[0.6, 0.3, 0.1])
    img[:, 5] = 0                                # a row with no hit
    for i in range(3):
        has, col = polar.first_hit_per_row(torch.from_numpy(img)[i], 3)
        jhas, jcol = jpolar.first_hit_per_row(jnp.asarray(img[i]), 3)
        np.testing.assert_array_equal(has.numpy(), np.asarray(jhas))
        np.testing.assert_array_equal(col.numpy(), np.asarray(jcol))
        got = polar.splat_first_hits(has, col, (40, 25), 100, torch.uint8)
        want = jpolar.splat_first_hits(jhas, jcol, (40, 25), 100,
                                       jnp.uint8)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # batched, each frame as alone
    has, col = polar.first_hit_per_row(torch.from_numpy(img), 3)
    batch = polar.splat_first_hits(has, col, (40, 25), 1, torch.uint8)
    for i in range(3):
        h1, c1 = polar.first_hit_per_row(torch.from_numpy(img[i]), 3)
        np.testing.assert_array_equal(
            batch[i].numpy(),
            polar.splat_first_hits(h1, c1, (40, 25), 1, torch.uint8).numpy())


@pytest.mark.parametrize("g", GRIDS, ids=["20x20", "80x60"])
@pytest.mark.parametrize("mode", ["multiclass", "binary"])
@pytest.mark.parametrize("interpolation", ["cv2_linear", "native"])
def test_laserscan_grids_equal_jax(g, mode, interpolation):
    cal = dataclasses.replace(toy_calibration((32, 64)), laserscan=True)
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    assert jcal.laserscan
    rng = np.random.default_rng(2)
    hi = 3 if mode == "multiclass" else 2
    segs = rng.integers(0, hi, (3, 32, 64)).astype(np.uint8)
    segs[:, 20:] = 1 if mode == "binary" else 2    # a road ahead
    jb = JB(jcal, JGrid(*g), mode=mode, interpolation=interpolation)
    tb = OccupancyGridBuilder(cal, port.GridConfig(*g), mode=mode,
                              interpolation=interpolation, device="cpu")
    got = tb(segs)
    for i, seg in enumerate(segs):
        want = jb(seg)
        one = tb(seg)
        if mode == "binary":
            assert isinstance(got, tuple) and len(got) == 2
            for k in range(2):
                np.testing.assert_array_equal(got[k][i].numpy(),
                                              np.asarray(want[k]))
                np.testing.assert_array_equal(one[k].numpy(),
                                              np.asarray(want[k]))
        else:
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
            np.testing.assert_array_equal(one.numpy(), np.asarray(want))


def test_pipeline_binary_laserscan_stacks_pair_and_streams():
    cal = dataclasses.replace(toy_calibration((32, 64)), laserscan=True)
    eng = port.build_engine("enet", port.ModelConfig(
        input_width=64, input_height=32, dtype="float32"),
        variables=random_enet_variables(4), device="cpu")
    grid = port.GridConfig(4.0, 4.0, 0.2)
    pipe = port.Pipeline(eng, cal, grid, mode="binary")
    rng = np.random.default_rng(3)
    frames = [rng.integers(0, 256, (48, 96, 3), np.uint8) for _ in range(5)]
    out = pipe(frames[0]).numpy()
    assert out.shape == (2, 20, 20) and out.dtype == np.int8
    plain, ray = OccupancyGridBuilder(cal, grid, mode="binary",
                                      device="cpu")(
        eng.predict_binary(frames[0]))
    np.testing.assert_array_equal(out[0], plain.numpy())
    np.testing.assert_array_equal(out[1], ray.numpy())
    want = np.stack([pipe(f).numpy() for f in frames])
    streamed = list(pipe.stream(iter(frames), depth=2))
    assert len(streamed) == 5 and streamed[0].shape == (2, 20, 20)
    np.testing.assert_array_equal(np.stack(streamed), want)
    np.testing.assert_array_equal(pipe.run_batch(np.stack(frames)).numpy(),
                                  want)
    np.testing.assert_array_equal(
        np.stack(list(pipe.stream(iter(frames), transfer_batch=4))), want)
