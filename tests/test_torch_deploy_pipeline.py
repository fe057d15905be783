"""The port's pipeline and rig artifacts (``deploy.export_pipeline``,
``export_multicam``) against the live port programs and the JAX package's,
on the CPU, and an artifact loaded without the model code.

The pipeline and rig cases of ``tests/test_deploy.py`` in the port: grids and segmentation maps equal the live
port program's bit for bit and the JAX program's within ``TIE_BUDGET``
(5e-4).  The contour filter's fixed points export as ``while_loop``s
(``postproc._traced_fixed_point``) and give the live labels.  The host
steps (resize, I420 pack) stay on the host: an i420 artifact takes what
``Pipeline._upload`` ships.  The engine cases are in
``tests/test_torch_deploy.py``.
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.models.api import Engine as JEngine
from bugcar_image_segmentation_tpu.models.enet import ENet as JENet
from bugcar_image_segmentation_tpu.pipeline import (
    MultiCameraPipeline as JRig, Pipeline as JPipeline)
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import deploy
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.ops import yuv

from test_torch_deploy import (CFG, assert_equal, assert_within_ties,
                               frames)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
GRID = (4.0, 4.0, 0.2)


@pytest.fixture(scope="module")
def jax_engine():
    return JEngine(JENet(num_classes=15, dtype=jnp.float32), JModel(**CFG))


@pytest.fixture(scope="module")
def engine(jax_engine):
    variables = jax.tree_util.tree_map(np.asarray, jax_engine.variables)
    return port.build_engine("enet_fused", port.ModelConfig(**CFG),
                             variables=variables, device="cpu")


def _cal():
    cal = toy_calibration((32, 64))
    return cal, JCal.from_reference_dict(cal.to_reference_dict())


@pytest.fixture(scope="module")
def bgr_artifact(engine, tmp_path_factory):
    pipe = port.Pipeline(engine, _cal()[0], port.GridConfig(*GRID))
    path = tmp_path_factory.mktemp("pipe") / "pipe.bcseg"
    deploy.export_pipeline_to(str(path), pipe)
    return pipe, path


@pytest.mark.parametrize("option", ["bgr", "contour_filter"])
def test_frame_to_grid_parity(engine, jax_engine, bgr_artifact, option,
                              tmp_path):
    rng = np.random.default_rng(6)
    cal, jcal = _cal()
    kw = {"contour_filter": True} if option == "contour_filter" else {}
    if option == "bgr":
        pipe, path = bgr_artifact
    else:
        pipe = port.Pipeline(engine, cal, port.GridConfig(*GRID), **kw)
        path = tmp_path / "pipe.bcseg"
        deploy.export_pipeline_to(str(path), pipe)
    dep = deploy.load_artifact(str(path))
    jpipe = JPipeline(jax_engine, jcal, JGrid(*GRID), **kw)
    for frame in frames(rng, 3):
        grid, seg = dep(frame)
        g0, s0 = pipe.segment_and_grid(frame)
        assert_equal(grid, g0)
        assert_equal(seg, s0)
        jg, js = jpipe.segment_and_grid(frame)
        assert_within_ties(grid, jg)
        assert_within_ties(seg, js)
    assert dep.meta["kind"] == "pipeline"
    assert dep.meta["mode"] == "multiclass"


def test_i420_requires_shape(engine):
    pipe = port.Pipeline(engine, _cal()[0], port.GridConfig(*GRID),
                         host_resize=True, transport="i420")
    with pytest.raises(ValueError, match="frame_shape is required"):
        deploy.export_pipeline(pipe)


def test_i420_with_shape(engine, tmp_path):
    rng = np.random.default_rng(8)
    pipe = port.Pipeline(engine, _cal()[0], port.GridConfig(*GRID),
                         host_resize=True, transport="i420")
    path = str(tmp_path / "pipe_i420.bcseg")
    deploy.export_pipeline_to(path, pipe,
                              frame_shape=yuv.i420_shape((32, 64)))
    dep = deploy.load_artifact(path)
    assert dep.meta["transport"] == "i420"
    for frame in frames(rng, 2, 48, 96):     # capture-size frames
        # the host steps stay on the host: resize + pack, then ship
        grid, _ = dep(pipe._prep_host(frame))
        assert_equal(grid, pipe(frame))


def test_rig_roundtrip(engine, jax_engine, tmp_path):
    rng = np.random.default_rng(9)
    cals = [toy_calibration((32, 64), yaw=y) for y in (0.12, -0.4)]
    rig = port.MultiCameraPipeline(engine, cals, port.GridConfig(*GRID))
    path = str(tmp_path / "rig.bcseg")
    deploy.export_multicam_to(path, rig)
    dep = deploy.load_artifact(path)
    assert dep.meta["kind"] == "multicam"
    assert dep.meta["n_cameras"] == 2
    assert dep.meta["in_avals"] == ["uint8[2, 32, 64, 3]"]
    jrig = JRig(jax_engine, [JCal.from_reference_dict(c.to_reference_dict())
                             for c in cals], JGrid(*GRID))
    x = frames(rng, 2)
    assert_equal(dep(x), rig(x))
    assert_within_ties(dep(x), jrig(x))


def test_loads_without_the_model_code(bgr_artifact, tmp_path):
    """A pipeline artifact runs in a process where models/, convert/,
    pipeline, grid -- and JAX -- cannot be imported, and gives the live
    grid."""
    rng = np.random.default_rng(10)
    pipe, path = bgr_artifact
    frame = frames(rng, 1)[0]
    np.save(tmp_path / "frame.npy", frame)
    np.save(tmp_path / "grid.npy", pipe(frame).numpy())
    code = f"""
import sys
import numpy as np
for m in ("models", "convert", "pipeline", "grid"):
    sys.modules["bugcar_image_segmentation_tpu_torch." + m] = None
for m in ("jax", "flax", "cv2", "msgpack", "bugcar_image_segmentation_tpu"):
    sys.modules[m] = None
from bugcar_image_segmentation_tpu_torch import deploy
dep = deploy.load_artifact({str(path)!r})
grid, seg = dep(np.load({str(tmp_path / 'frame.npy')!r}))
assert np.array_equal(grid.numpy(), np.load({str(tmp_path / 'grid.npy')!r}))
print("ok")
"""
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr
