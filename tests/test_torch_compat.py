"""The port's drop-in layer (``compat.py``) against the JAX package's
``compat``: tests/test_compat.py's reference call sites, run on both with
the same inputs.

- ``ENET`` loading a frozen ``.pb`` written here (seeded weights, the JAX
  exporter, 64x32): ``preprocess`` → ``predict`` / ``predict_binary``
  equal to the JAX ``ENET``'s on the same file, float32; without a file
  both warn and start from their own initial weights (shapes and values
  checked; the weights differ).
- ``bev_transform_tools``: the reference grid calls give the JAX grids,
  and each side reads the other's JSON.
- ``contour_noise_removal`` equal; ``clahe`` equal on at least 0.999 of
  its bytes (the pinned share of tests/test_torch_postproc.py: XLA folds
  the float steps of the JAX CLAHE differently); the message alias and
  the geometry aliases equal.
"""

import dataclasses

import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import compat as jcompat
from bugcar_image_segmentation_tpu.configs import ModelConfig as JModel
from bugcar_image_segmentation_tpu_torch import compat
from bugcar_image_segmentation_tpu_torch.configs import ModelConfig
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables

CLAHE_EQUAL = 0.999
TINY = dict(input_width=64, input_height=32, dtype="float32")


class TinyENET(compat.ENET):
    _CFG = ModelConfig(**TINY)


class JTinyENET(jcompat.ENET):
    _CFG = JModel(**TINY)


@pytest.fixture(scope="module")
def pb(tmp_path_factory):
    pytest.importorskip("tensorflow")
    from bugcar_image_segmentation_tpu.convert.tf_enet import export_enet_pb
    path = str(tmp_path_factory.mktemp("pb") / "enet.pb")
    export_enet_pb(random_enet_variables(12), 15, (32, 64), path)
    return path


@pytest.fixture(scope="module")
def pair(pb):
    """The port's ENET from the file, and the JAX ENET with the JAX
    converter's pour of it (its init compiled once, not run op by op)."""
    import jax
    import jax.numpy as jnp
    from bugcar_image_segmentation_tpu.convert.tf_graphdef import \
        convert_frozen_graph

    jax_enet = JTinyENET(None)
    module = jax_enet.engine.module

    class Jitted:
        def init(self, key, x, train=False):
            return jax.jit(lambda k, a: module.init(k, a, train=train))(
                key, x)

    jax_enet.engine.load_variables(convert_frozen_graph(
        pb, Jitted(), jnp.zeros((1, 32, 64, 3), jnp.float32)))
    return TinyENET(pb, device="cpu"), jax_enet


def frames(seed, n=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (48, 96, 3), dtype=np.uint8)
            for _ in range(n)]


def test_enet_from_pb_predicts_as_jax(pair):
    port, jax_enet = pair
    for frame in frames(1):
        batch = port.preprocess(frame)
        jbatch = jax_enet.preprocess(frame)
        assert tuple(batch.shape) == (1, 32, 64, 3)
        np.testing.assert_allclose(batch.numpy(), np.asarray(jbatch),
                                   rtol=1e-6, atol=1e-6)
        seg = port.predict(batch)
        assert seg.shape == (32, 64) and seg.dtype == np.uint8
        np.testing.assert_array_equal(seg, jax_enet.predict(jbatch))
        np.testing.assert_array_equal(port.predict_binary(batch),
                                      jax_enet.predict_binary(jbatch))
    assert len(np.unique(port.predict(port.preprocess(frame)))) > 1


def test_enet_without_pb_warns_and_serves():
    with pytest.warns(UserWarning, match="not found"):
        enet = TinyENET("./pretrained_models/enet.pb", device="cpu")
    frame = frames(2, 1)[0]
    seg = enet.predict(enet.preprocess(frame))
    assert seg.shape == (32, 64) and seg.dtype == np.uint8
    assert set(np.unique(seg)) <= {0, 1, 2}
    assert set(np.unique(enet.predict_binary(enet.preprocess(frame)))) <= \
        {0, 1}


def test_deeplab_without_pb_warns_and_serves():
    class Tiny(compat.DeepLabV3):
        _CFG = dataclasses.replace(compat.DeepLabV3._CFG, input_width=64,
                                   input_height=32, dtype="float32")

    with pytest.warns(UserWarning, match="not found"):
        dl = Tiny("./pretrained_models/deeplab.pb", device="cpu")
    seg = dl.predict(frames(3, 1)[0])
    assert seg.shape == (32, 64) and seg.dtype == np.uint8
    assert set(np.unique(seg)) <= {0, 1, 2}


def test_class_constants_match_reference():
    for name in ("INPUT_WIDTH", "INPUT_HEIGHT"):
        assert getattr(compat.ENET, name) == getattr(jcompat.ENET, name)
    np.testing.assert_array_equal(compat.ENET.IMAGE_MEAN,
                                  jcompat.ENET.IMAGE_MEAN)
    np.testing.assert_array_equal(compat.ENET.IMAGE_STD,
                                  jcompat.ENET.IMAGE_STD)
    assert compat.DeepLabV3.INPUT_SIZE == jcompat.DeepLabV3.INPUT_SIZE


BEV_ARGS = ((64, 32), (128, 128), (2.0, 30.0), 60.0, 4.0, 0.12)
TILE = np.array([[26.0, 21.0], [38.0, 21.0], [41.0, 29.0], [23.0, 30.0]])


def bevs():
    port = compat.bev_transform_tools(*BEV_ARGS, device="cpu")
    jbev = jcompat.bev_transform_tools(*BEV_ARGS)
    np.testing.assert_allclose(port.calculate_transform_matrix(TILE),
                               jbev.calculate_transform_matrix(TILE),
                               rtol=1e-12, atol=1e-12)
    return port, jbev


@pytest.mark.parametrize("mode", ["multiclass", "binary"])
def test_reference_grid_calls_equal_jax(mode):
    port, jbev = bevs()
    rng = np.random.default_rng(4)
    call = ("create_occupancy_grid" if mode == "multiclass"
            else "create_occupancy_grid_binary")
    for _ in range(2):
        seg = rng.integers(0, 3 if mode == "multiclass" else 2, (32, 64),
                           dtype=np.uint8)
        got = getattr(port, call)(seg, 4, 4, 0.2)
        want = np.asarray(getattr(jbev, call)(seg, 4, 4, 0.2))
        assert got.shape == (20, 20) and got.dtype == np.int8
        np.testing.assert_array_equal(got, want)


def test_json_roundtrip_both_ways(tmp_path):
    port, jbev = bevs()
    port.save_to_JSON(str(tmp_path / "port.json"))
    jbev.save_to_JSON(str(tmp_path / "jax.json"))
    np.testing.assert_allclose(
        jcompat.bev_transform_tools.fromJSON(str(tmp_path / "port.json"))
        .matrix, jbev.matrix)
    again = compat.bev_transform_tools.fromJSON(str(tmp_path / "jax.json"),
                                                device="cpu")
    np.testing.assert_allclose(again.matrix, port.matrix)
    assert again.device == "cpu"


def test_contour_noise_removal_equals_jax():
    rng = np.random.default_rng(5)
    for _ in range(2):
        mask = (rng.random((64, 128)) > 0.5).astype(np.uint8)
        got = compat.contour_noise_removal(mask, device="cpu")
        assert got.shape == mask.shape and got.dtype == np.uint8
        np.testing.assert_array_equal(got,
                                      jcompat.contour_noise_removal(mask))


def test_clahe_equals_jax_on_the_pinned_share():
    img = np.random.default_rng(6).integers(0, 256, (64, 64, 3),
                                            dtype=np.uint8)
    got = compat.clahe(img, device="cpu")
    assert got.shape == img.shape and got.dtype == np.uint8
    assert (got == jcompat.clahe(img)).mean() >= CLAHE_EQUAL


def test_msg_and_geometry_aliases_equal_jax():
    grid = np.random.default_rng(7).integers(-1, 101, (20, 20)).astype(
        np.int8)
    args = (grid, 0.2, 4.0, 4.0, 0.0, "base_link", [0, 0, 0, 0, 0, 0.3])
    m, jm = (compat.convert_to_occupancy_grid_msg(*args),
             jcompat.convert_to_occupancy_grid_msg(*args))
    assert m.data.shape == (400,)
    np.testing.assert_array_equal(m.data, jm.data)
    for field in dataclasses.fields(m):
        np.testing.assert_array_equal(np.asarray(getattr(m, field.name)),
                                      np.asarray(getattr(jm, field.name)))
    lines = ([(0, 0), (1, 1)], [(1, 0), (0, 1)])
    np.testing.assert_allclose(compat.find_intersection_line(*lines),
                               jcompat.find_intersection_line(*lines))
    pts = np.random.default_rng(8).random((4, 2))
    axis = np.array([[0.5, 0.5], [0.9, 0.6]])
    np.testing.assert_array_equal(
        compat.order_points_counter_clockwise(pts, axis),
        jcompat.order_points_counter_clockwise(pts, axis))
