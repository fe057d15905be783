"""The port's camera rig (``pipeline.MultiCameraPipeline``,
``stitch_grids``) against the JAX package's, float32: the stitched grid is
the elementwise max of the per-camera grids, and bit-equal to the JAX
``MultiCameraPipeline``'s for ``enet`` (cv2_linear grids) and for
``deeplab_q`` on the native grid, which reads the quarter-resolution
labels (mirroring the JAX package's tests/test_pipeline_eval.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import \
    MultiCameraPipeline as JRig
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_deeplab import \
    random_deeplab_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables

HW = (32, 64)
GRID = (4.0, 4.0, 0.2)
YAWS = (-0.4, 0.0, 0.3, 0.7)
CASES = {"enet": (random_enet_variables, "cv2_linear"),
         "deeplab_q": (random_deeplab_variables, "native")}


@pytest.fixture(autouse=True)
def one_thread():
    """Long chains of small torch ops: one intra-op thread each, so that
    they do not stall on a host whose cores other test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def rig_inputs():
    cals = [toy_calibration(HW, yaw=y) for y in YAWS]
    rng = np.random.default_rng(5)
    frames = rng.integers(0, 256, (2, len(YAWS)) + HW + (3,), np.uint8)
    return cals, frames


@pytest.mark.parametrize("name", list(CASES))
def test_rig_equals_jax_and_per_camera_max(rig_inputs, name):
    cals, frames = rig_inputs
    make, interp = CASES[name]
    v = make(7)
    cfg = dict(name=name, input_width=HW[1], input_height=HW[0],
               dtype="float32")
    jeng = jbuild(name, JModel(**cfg),
                  variables=jax.tree_util.tree_map(jnp.asarray, v))
    jrig = JRig(jeng, [JCal.from_reference_dict(c.to_reference_dict())
                       for c in cals], JGrid(*GRID), interpolation=interp)
    eng = port.build_engine(name, port.ModelConfig(**cfg), variables=v,
                            device="cpu")
    rig = port.MultiCameraPipeline(eng, cals, port.GridConfig(*GRID),
                                   interpolation=interp)
    assert rig.builders[0].label_scale == (4 if name == "deeplab_q" else 1)
    cams = [port.Pipeline(eng, c, port.GridConfig(*GRID),
                          interpolation=interp) for c in cals]
    for f in frames:
        got = rig(f).numpy()
        assert got.dtype == np.int8 and got.shape == (20, 20)
        np.testing.assert_array_equal(got, np.asarray(jrig(f)))
        per_cam = np.stack([p(f[i]).numpy() for i, p in enumerate(cams)])
        np.testing.assert_array_equal(got, per_cam.max(0))


def test_stitch_semantics():
    unknown = torch.full((4, 4), -1, dtype=torch.int8)
    free = torch.zeros((4, 4), dtype=torch.int8)
    occ = torch.full((4, 4), 100, dtype=torch.int8)
    assert int(port.stitch_grids(torch.stack([unknown, free]))[0, 0]) == 0
    assert int(port.stitch_grids(torch.stack([free, occ, unknown]))[1, 1]) \
        == 100
    mixed = torch.stack([unknown, torch.where(torch.eye(4, dtype=torch.bool),
                                              occ, unknown)])
    np.testing.assert_array_equal(
        port.stitch_grids(mixed).numpy(),
        np.where(np.eye(4, dtype=bool), 100, -1).astype(np.int8))


def test_rig_rejects(rig_inputs):
    cals, frames = rig_inputs
    eng = port.build_engine("enet", port.ModelConfig(
        input_width=HW[1], input_height=HW[0], dtype="float32"),
        device="cpu")
    grid = port.GridConfig(*GRID)
    with pytest.raises(ValueError, match="at least one"):
        port.MultiCameraPipeline(eng, [], grid)
    rig = port.MultiCameraPipeline(eng, cals, grid)
    with pytest.raises(ValueError, match="one per camera"):
        rig(frames[0][:3])
    with pytest.raises(ValueError, match="segmap shape"):
        port.MultiCameraPipeline(eng, [toy_calibration((64, 128))],
                                 grid)(frames[0][:1])
