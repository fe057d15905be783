"""The port's Pipeline, configs, geometry and import hygiene against the
JAX package.

Grids of the port's ``Pipeline`` must equal the JAX ``Pipeline``'s on the
same bridged weights and the same frames, f32, for ``__call__``, batched
runs (chunks of at most 4 frames) and ``stream``; configs round-trip
through the reference JSON schema in both directions; the homography math
gives identical matrices.  The port must import without jax, flax, cv2,
msgpack or the JAX package (a subprocess with those poisoned).
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bugcar_image_segmentation_tpu import geometry as jgeometry
from bugcar_image_segmentation_tpu import synthetic as jsynthetic
from bugcar_image_segmentation_tpu.calibration import BEVTransform as JBEV
from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import geometry, synthetic
from bugcar_image_segmentation_tpu_torch.calibration import (
    BEVTransform, toy_calibration)
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "bugcar_image_segmentation_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "cv2", "msgpack",
             "tensorflow", "bugcar_image_segmentation_tpu")
# Modules of the later slices, named so that the poisoned import below
# cannot miss one.
SLICE_MODULES = ("ops.cuda.attention", "models.segformer",
                 "convert.flax_segformer", "ops.cuda.sepconv",
                 "models.layers", "models.deeplab", "models.xception",
                 "convert.flax_xception", "ops.yuv", "ops.host_resize",
                 "utils.msgpack", "utils.checkpoint", "ops.cuda.probes",
                 "models.unet", "convert.flax_tree", "convert.flax_deeplab",
                 "convert.flax_unet", "ops.polar", "postproc", "ops.quant",
                 "fusion", "fov", "msg", "evaluation")
GRID = (4.0, 4.0, 0.2)
MODEL = dict(input_width=64, input_height=32, dtype="float32")


@pytest.fixture(scope="module")
def pair():
    """JAX and port pipelines on the same seeded weights and calibration,
    plus the JAX grids of a 7-frame sequence of 96x48 frames."""
    v = random_enet_variables(21)
    cal = toy_calibration((32, 64))
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    jeng = jbuild("enet", JModel(**MODEL),
                  variables=jax.tree_util.tree_map(jnp.asarray, v))
    jpipe = JPipeline(jeng, jcal, JGrid(*GRID))
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (48, 96, 3), np.uint8) for _ in range(7)]
    want = np.stack([np.asarray(jpipe(f)) for f in frames])
    return v, cal, jpipe, frames, want


@pytest.mark.parametrize("name", ["enet", "enet_fused"])
def test_pipeline_grids_equal_jax(pair, name):
    v, cal, _, frames, want = pair
    eng = port.build_engine(name, port.ModelConfig(name=name, **MODEL),
                            variables=v, device="cpu")
    pipe = port.Pipeline(eng, cal, port.GridConfig(*GRID))
    single = np.stack([pipe(f).numpy() for f in frames])
    assert single.dtype == np.int8 and single.shape == (7, 20, 20)
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(
        pipe.run_batch(np.stack(frames[:4])).numpy(), want[:4])
    np.testing.assert_array_equal(pipe.run_batch(np.stack(frames)).numpy(),
                                  want)
    for depth, sync_chunk in ((2, None), (1, 1), (3, 2)):
        np.testing.assert_array_equal(
            np.stack(list(pipe.stream(iter(frames), depth=depth,
                                      sync_chunk=sync_chunk))), want)


def test_segment_and_grid_matches_jax(pair):
    v, cal, jpipe, frames, want = pair
    eng = port.build_engine("enet", port.ModelConfig(**MODEL), variables=v,
                            device="cpu")
    pipe = port.Pipeline(eng, cal, port.GridConfig(*GRID))
    grid, seg = pipe.segment_and_grid(frames[0])
    jgrid, jseg = jpipe.segment_and_grid(frames[0])
    np.testing.assert_array_equal(seg.numpy(), np.asarray(jseg))
    np.testing.assert_array_equal(grid.numpy(), want[0])
    with pytest.raises(ValueError, match="at most 4"):
        pipe.run_chunk(np.stack(frames[:5]))


def test_binary_and_native_pipelines_equal_jax(pair):
    v, cal, _, frames, _ = pair
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    jeng = jbuild("enet", JModel(**MODEL),
                  variables=jax.tree_util.tree_map(jnp.asarray, v))
    eng = port.build_engine("enet", port.ModelConfig(**MODEL), variables=v,
                            device="cpu")
    for kw in (dict(mode="binary"), dict(interpolation="native")):
        jp = JPipeline(jeng, jcal, JGrid(*GRID), **kw)
        tp = port.Pipeline(eng, cal, port.GridConfig(*GRID), **kw)
        np.testing.assert_array_equal(
            tp.run_batch(np.stack(frames[:3])).numpy(),
            np.stack([np.asarray(jp(f)) for f in frames[:3]]))


def test_unported_options_raise(pair):
    v, cal, _, _, _ = pair
    eng = port.build_engine("enet", port.ModelConfig(**MODEL), variables=v,
                            device="cpu")
    grid = port.GridConfig(*GRID)
    # CLAHE, the contour filter and laserscan calibrations are ported
    # (tests/test_torch_postproc.py, tests/test_torch_polar.py)
    for kw in (dict(use_clahe=True), dict(contour_filter=True)):
        port.Pipeline(eng, cal, grid, **kw)
    port.Pipeline(eng, dataclasses.replace(cal, laserscan=True), grid)
    # the i420 transport and the host resize are ported (they are the
    # bench path; tests/test_torch_bench_path.py); i420 needs the host
    # resize, as in the JAX package
    with pytest.raises(ValueError, match="requires host_resize"):
        port.Pipeline(eng, cal, grid, transport="i420")
    port.Pipeline(eng, cal, grid, host_resize=True, transport="i420")
    with pytest.raises(ValueError, match="unknown transport"):
        port.Pipeline(eng, cal, grid, transport="yuv")
    with pytest.raises(ValueError, match="must match"):
        port.Pipeline(eng, toy_calibration((64, 128)), grid)


def test_warmup_and_default_stream(pair):
    v, cal, _, frames, want = pair
    eng = port.build_engine("enet", port.ModelConfig(**MODEL), variables=v,
                            device="cpu")
    pipe = port.Pipeline(eng, cal, port.GridConfig(*GRID))
    assert pipe.warmup((48, 96, 3)) >= 0.0
    np.testing.assert_array_equal(np.stack(list(pipe.stream(frames))), want)
    with pytest.raises(ValueError, match="depth"):
        list(pipe.stream(frames, depth=0))


def test_calibration_json_round_trips_both_ways(tmp_path):
    cal = toy_calibration((256, 512))
    p1, p2 = tmp_path / "port.json", tmp_path / "jax.json"
    cal.save_json(str(p1))
    jcal = JCal.load_json(str(p1))
    assert jcal.to_reference_dict() == cal.to_reference_dict()
    jcal.save_json(str(p2))
    assert json.loads(p1.read_text()) == json.loads(p2.read_text())
    assert port.CalibrationConfig.load_json(str(p2)) == cal
    # a reference-written file without the is_laserscan key loads
    raw = json.loads(p1.read_text())
    raw.pop("is_laserscan")
    assert not port.CalibrationConfig.from_reference_dict(raw).laserscan


def test_bev_transform_matches():
    corners = np.array([[210.0, 141.0], [302.0, 141.0], [328.0, 184.0],
                        [184.0, 187.0]])
    kw = dict(input_shape=(512, 256), output_shape=(400, 400),
              dist2target=(5.0, 80.0), tile_length=50.0, cm_per_px=2.0,
              yaw=0.1)
    a, b = JBEV(**kw), BEVTransform(**kw)
    np.testing.assert_array_equal(b.calculate_transform_matrix(corners),
                                  a.calculate_transform_matrix(corners))
    assert b.config.to_reference_dict() == a.config.to_reference_dict()


def test_geometry_identical():
    rng = np.random.default_rng(9)
    src = rng.uniform(0, 500, (4, 2))
    dst = rng.uniform(0, 500, (4, 2))
    np.testing.assert_array_equal(geometry.get_perspective_transform(src, dst),
                                  jgeometry.get_perspective_transform(src,
                                                                      dst))
    m = jgeometry.get_perspective_transform(src, dst)
    np.testing.assert_array_equal(geometry.invert_homography(m),
                                  jgeometry.invert_homography(m))
    pts = rng.uniform(0, 500, (5, 2))
    np.testing.assert_array_equal(geometry.apply_homography(m, pts),
                                  jgeometry.apply_homography(m, pts))
    for yaw in (0.0, 0.3, -1.2):
        np.testing.assert_array_equal(
            geometry.order_corners_for_calibration(src, yaw),
            jgeometry.order_corners_for_calibration(src, yaw))
        np.testing.assert_array_equal(
            geometry.bev_tile_corners((400, 300), (3.0, 70.0), 40.0, 2.0,
                                      yaw),
            jgeometry.bev_tile_corners((400, 300), (3.0, 70.0), 40.0, 2.0,
                                       yaw))
    lines = [((0, 0), (10, 0)), ((10, 0), (10, 10)), ((10, 10), (0, 10)),
             ((0, 10), (0, 0))]
    np.testing.assert_array_equal(geometry.corners_from_edge_lines(lines),
                                  jgeometry.corners_from_edge_lines(lines))


def test_grid_and_model_configs_match():
    for g in ((8.0, 8.0, 0.1), (4.0, 6.0, 0.25)):
        a, b = JGrid(*g), port.GridConfig(*g)
        assert (a.cells_w, a.cells_h, a.template_px(2.0)) == \
               (b.cells_w, b.cells_h, b.template_px(2.0))
    assert dataclasses.asdict(JModel()) == dataclasses.asdict(
        port.ModelConfig())


def test_synthetic_frames_identical():
    a = jsynthetic.road_scene(np.random.default_rng(3), (120, 160))
    b = synthetic.road_scene(np.random.default_rng(3), (120, 160))
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    for (fa, la, oa), (fb, lb, ob) in zip(
            jsynthetic.video(seed=2, num_frames=3, shape=(96, 128)),
            synthetic.video(seed=2, num_frames=3, shape=(96, 128))):
        np.testing.assert_array_equal(fa, fb)
        np.testing.assert_array_equal(la, lb)
        assert oa == ob


def _imported_roots(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


# msg.py's ROS edge: imported only inside to_rospy_msg and GridPublisher
# (absent on both hosts; importing msg needs none of it, as the poisoned
# import below shows)
ROS_EDGE = {"rospy", "nav_msgs", "geometry_msgs", "std_msgs"}


def test_port_and_smoke_import_only_what_the_gpu_host_has():
    """Every import in the port, chip_smoke.py and scripts/torch_*.py
    names the stdlib, torch, numpy, scipy, einops or the port itself (and
    msg.py's lazy ROS edge)."""
    allowed = set(sys.stdlib_module_names) | {
        "torch", "numpy", "scipy", "einops",
        "bugcar_image_segmentation_tpu_torch"}
    files = (sorted(PORT.rglob("*.py")) + [REPO / "chip_smoke.py"]
             + sorted((REPO / "scripts").glob("torch_*.py")))
    assert len(files) > 15
    for f in files:
        edge = ROS_EDGE if f == PORT / "msg.py" else set()
        bad = set(_imported_roots(f)) - allowed - edge
        assert not bad, f"{f.relative_to(REPO)} imports {sorted(bad)}"


def test_port_imports_with_jax_cv2_msgpack_poisoned():
    code = f"""
import importlib, pkgutil, sys
for name in {FORBIDDEN!r}:
    sys.modules[name] = None        # any import of it raises ImportError
import bugcar_image_segmentation_tpu_torch as port
mods = [m.name for m in pkgutil.walk_packages(port.__path__, port.__name__ + ".")]
for m in mods:
    importlib.import_module(m)
for m in {SLICE_MODULES!r}:
    assert "bugcar_image_segmentation_tpu_torch." + m in mods, m
import chip_smoke
leaked = [m for m in sys.modules if sys.modules[m] is not None
          and m.split(".")[0] in {FORBIDDEN!r}]
assert not leaked, leaked
print(len(mods))
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert int(out.stdout.strip().splitlines()[-1]) >= 15


def test_chip_smoke_refuses_without_a_card():
    """Without CUDA the smoke script exits non-zero and prints no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=str(REPO),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
