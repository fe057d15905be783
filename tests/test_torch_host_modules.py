"""The port's host-side library modules against the JAX package's, exact:
``fov.fov_mask`` / ``fov_outline`` (from the port's own warp plan), the
ROS message (``msg.to_occupancy_grid_msg`` and its rotation helpers),
``evaluation`` (``confusion_matrix``, ``evaluate_model``, ``bit_parity``),
the one-shot ``create_occupancy_grid[_binary]`` and ``segment_frame``, on
the same calibrations, grids, weights and numpy-made frames (float32).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import evaluation as jeval
from bugcar_image_segmentation_tpu import fov as jfov
from bugcar_image_segmentation_tpu import msg as jmsg
from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.grid import (
    create_occupancy_grid as jcreate,
    create_occupancy_grid_binary as jcreate_binary)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import \
    segment_frame as jsegment_frame
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import evaluation, fov, msg
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables

HW = (32, 64)
GRID = (4.0, 4.0, 0.2)
MODEL = dict(input_width=HW[1], input_height=HW[0], dtype="float32")


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcal(cal):
    return JCal.from_reference_dict(cal.to_reference_dict())


@pytest.mark.parametrize("hw,yaw,grid", [
    ((32, 64), 0.0, (4.0, 4.0, 0.2)), ((64, 128), 0.4, (6.0, 5.0, 0.25)),
    ((128, 256), -0.7, (8.0, 8.0, 0.1))])
def test_fov_equals_jax(hw, yaw, grid):
    cal = toy_calibration(hw, yaw=yaw)
    mask = fov.fov_mask(cal, port.GridConfig(*grid))
    want = jfov.fov_mask(_jcal(cal), JGrid(*grid))
    assert mask.dtype == np.uint8 and 0 < mask.sum() < mask.size
    np.testing.assert_array_equal(mask, want)
    outline = fov.fov_outline(cal, port.GridConfig(*grid))
    np.testing.assert_array_equal(outline,
                                  jfov.fov_outline(_jcal(cal), JGrid(*grid)))
    assert outline.sum() > 0 and (mask[outline == 1] == 1).all()


@pytest.mark.parametrize("pose", [(0.0,) * 6, (0.3, -0.2, 0.1, 0.05, -0.1,
                                                0.7)])
def test_occupancy_grid_msg_equals_jax(pose):
    grid = np.random.default_rng(1).choice(
        np.array([-1, 0, 100], np.int8), (40, 30))
    got = msg.to_occupancy_grid_msg(grid, 0.1, 3.0, 4.0, time_stamp=12.5,
                                    frame_id="cam", pose=pose)
    want = jmsg.to_occupancy_grid_msg(grid, 0.1, 3.0, 4.0, time_stamp=12.5,
                                      frame_id="cam", pose=pose)
    for f in dataclasses.fields(want):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b, f.name
    np.testing.assert_array_equal(got.grid2d(), want.grid2d())
    np.testing.assert_array_equal(msg.euler_xyz_to_matrix(pose[3:]),
                                  jmsg.euler_xyz_to_matrix(pose[3:]))
    assert msg.convert_to_occupancy_grid_msg is msg.to_occupancy_grid_msg
    pub = msg.GridPublisher()          # rospy is absent: collects
    pub.publish(got)
    assert pub.last_message is got
    with pytest.raises(ImportError):
        msg.to_rospy_msg(got)


def test_confusion_matrix_and_bit_parity_equal_jax():
    rng = np.random.default_rng(2)
    pred = rng.integers(0, 5, (3, 16, 24)).astype(np.uint8)
    label = rng.integers(0, 7, (3, 16, 24)).astype(np.int32)
    label[0, :2] = -1                        # outside [0, C): dropped
    got = evaluation.confusion_matrix(torch.from_numpy(pred),
                                      torch.from_numpy(label), 5)
    want = np.asarray(jeval.confusion_matrix(jnp.asarray(pred),
                                             jnp.asarray(label), 5))
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == int(((label >= 0) & (label < 5)).sum())
    a, b = pred[0], pred[1]
    assert evaluation.bit_parity(a, b) == jeval.bit_parity(a, b)
    assert evaluation.bit_parity(a, a)["parity"] == 1.0
    with pytest.raises(ValueError, match="shape"):
        evaluation.bit_parity(a, pred)


@pytest.fixture(scope="module")
def enet():
    """JAX and port ENet engines (f32, 64x32) on one seeded tree."""
    v = random_enet_variables(9)
    jeng = jbuild("enet", JModel(**MODEL),
                  variables=jax.tree_util.tree_map(jnp.asarray, v))
    eng = port.build_engine("enet", port.ModelConfig(**MODEL), variables=v,
                            device="cpu")
    return jeng, eng


@pytest.mark.parametrize("remap_labels", [True, False])
def test_evaluate_model_equals_jax(enet, remap_labels):
    jeng, eng = enet
    rng = np.random.default_rng(3)
    data = [(rng.integers(0, 256, (48, 96, 3), np.uint8),
             rng.integers(0, 15, HW).astype(np.uint8)) for _ in range(3)]
    data[1][1][:4] = 255                     # an ignore band
    got = evaluation.evaluate_model(eng, data, remap_labels=remap_labels)
    want = jeval.evaluate_model(jeng, data, remap_labels=remap_labels)
    np.testing.assert_array_equal(got.confusion, want.confusion)
    assert got.summary() == pytest.approx(want.summary(), nan_ok=True)
    np.testing.assert_array_equal(got.per_class_accuracy,
                                  want.per_class_accuracy)
    assert got.confusion.sum() > 0


@pytest.mark.parametrize("interp", ["cv2_linear", "nearest", "native"])
@pytest.mark.parametrize("laserscan", [False, True])
def test_create_occupancy_grid_equals_jax(interp, laserscan):
    cal = dataclasses.replace(toy_calibration(HW, yaw=0.2),
                              laserscan=laserscan)
    jcal = _jcal(cal)
    rng = np.random.default_rng(4)
    seg3 = rng.integers(0, 3, (2,) + HW).astype(np.uint8)
    seg2 = rng.integers(0, 2, HW).astype(np.uint8)
    got = port.create_occupancy_grid(seg3, cal, port.GridConfig(*GRID),
                                     interp, device="cpu")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jcreate(seg3, jcal, JGrid(*GRID), interp)))
    got = port.create_occupancy_grid_binary(seg2, cal, port.GridConfig(*GRID),
                                            interp, device="cpu")
    want = jcreate_binary(seg2, jcal, JGrid(*GRID), interp)
    if laserscan:                            # (plain, ray-cast), as JAX
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("mode", ["multiclass", "binary"])
def test_segment_frame_equals_jax(enet, mode):
    jeng, eng = enet
    cal = toy_calibration(HW)
    frame = np.random.default_rng(5).integers(0, 256, (48, 96, 3), np.uint8)
    got = port.segment_frame(frame, eng, cal, port.GridConfig(*GRID), mode)
    want = jsegment_frame(frame, jeng, _jcal(cal), JGrid(*GRID), mode)
    assert got.dtype == torch.int8 and got.shape == (20, 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
