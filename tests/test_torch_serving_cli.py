"""The port's serving CLIs on the CPU (``--device cpu``), held against the
JAX package: ``scripts/torch_inference_video.py`` (offline synthetic
stream), ``scripts/torch_serve_rig.py`` and ``scripts/torch_export_model.py``.

The streaming CLI, with the trained ENet checkpoint, loses no frame of an
offline stream (N/N, 0 dropped) and publishes, in order, the grids the
port's ``Pipeline`` gives on the JAX package's synthetic frames, bit for
bit; it builds the engine as the JAX CLI does (the name's default config:
bf16), and bf16 on the CPU sums in other orders than XLA, so its grids
agree with the JAX ``Pipeline``'s (host resize, the same checkpoint and
calibration) on >= 0.995 of the cells of each frame (measured 0.99688 at
the worst of 6 frames).  The rig CLI, which takes the checkpoint's config
as the JAX CLI does, runs its ticks (as
``tests/test_scripts.py::TestServeRigCLI`` does) on the checkpoint in f32
and stitches the JAX rig's grids bit for bit, fused over time as the JAX
CLI fuses them.  The export CLI
exports, inspects and smoke-runs an artifact, freezes a checkpoint at its
own resolution, and refuses ``--spatial > 1``.  The scripts run in this
process (``load_script``), as ``chip_smoke.py`` runs them.
"""

import dataclasses
import importlib.util
import json
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import io as jio
from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid)
from bugcar_image_segmentation_tpu.fusion import \
    TemporalGridFusion as JFusion
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import (
    MultiCameraPipeline as JRig, Pipeline as JPipeline)
from bugcar_image_segmentation_tpu.utils.checkpoint import \
    load_variables as jload
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
CKPT = REPO / "checkpoints" / "enet_synthetic.msgpack"
N_FRAMES = 6
BF16_CELLS = 0.995       # share of grid cells equal to JAX's in bf16


def load_script(name: str):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "scripts" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_ckpt():
    if not CKPT.exists():
        pytest.skip("checkpoints/ not in this checkout")
    return jload(str(CKPT))


@pytest.fixture(scope="module")
def calibs(tmp_path_factory):
    """Calibration files of the ENet's 512x256 input: straight, and two
    turned cameras of a rig."""
    root = tmp_path_factory.mktemp("cal")
    paths = []
    for i, yaw in enumerate((0.05, 0.12, -0.4)):
        path = root / f"cal{i}.json"
        toy_calibration((256, 512), yaw=yaw).save_json(str(path))
        paths.append(str(path))
    return paths


def test_inference_video_grids_equal_jax(jax_ckpt, calibs):
    cli = load_script("torch_inference_video")
    grids = []
    summary = cli.run(cli.parse_args([
        "--synthetic", str(N_FRAMES), "--calib", calibs[0], "--device",
        "cpu", "--checkpoint", str(CKPT)]), on_grid=grids.append)
    assert summary["frames"] == N_FRAMES and summary["dropped"] == 0
    assert len(grids) == N_FRAMES

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
        load_variables
    frames = list(jio.SyntheticSource((480, 640, 3), num_frames=N_FRAMES))
    pipe = port.Pipeline(
        port.build_engine("enet", variables=load_variables(str(CKPT))[0],
                          device="cpu"),
        port.CalibrationConfig.load_json(calibs[0]),
        port.GridConfig(8.0, 8.0, 0.1), host_resize=True)
    for got, frame in zip(grids, frames):
        assert got.dtype == np.int8
        np.testing.assert_array_equal(got, pipe(frame).numpy())

    variables, _ = jax_ckpt
    jeng = jbuild("enet", variables=variables)
    jcal = JCal.load_json(calibs[0])
    jpipe = JPipeline(jeng, jcal, JGrid(8.0, 8.0, 0.1), host_resize=True)
    for got, frame in zip(grids, frames):
        same = float(np.mean(got == np.asarray(jpipe(frame))))
        assert same >= BF16_CELLS, same
    # the trained ENet sees road ahead: free and occupied cells
    assert {0, 100} <= set(np.unique(np.stack(grids))) <= {-1, 0, 100}


def test_serve_rig_ticks_equal_jax(jax_ckpt, calibs, tmp_path):
    # the checkpoint with an f32 config beside it
    ck = tmp_path / "enet_f32.msgpack"
    ck.write_bytes(CKPT.read_bytes())
    variables, cfg = jax_ckpt
    cfg = dataclasses.replace(cfg, dtype="float32")
    (tmp_path / "enet_f32.msgpack.config.json").write_text(
        json.dumps(dataclasses.asdict(cfg)))
    cli = load_script("torch_serve_rig")
    grids = []
    summary = cli.run(cli.parse_args([
        "--calibs", *calibs[1:], "--synthetic", "4", "--model", "enet",
        "--checkpoint", str(ck), "--grid", "8x8x0.1", "--temporal-fusion",
        "--device", "cpu"]), on_grid=grids.append)
    assert summary["ticks"] == 4 and summary["cameras"] == 2
    assert summary["dropped"] == 0

    jeng = jbuild("enet", cfg=cfg, variables=jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float32), variables))
    jrig = JRig(jeng, [JCal.load_json(c) for c in calibs[1:]],
                JGrid(8.0, 8.0, 0.1))
    fusion = JFusion((80, 80), decay=0.9, backend="numpy")
    sources = [iter(jio.SyntheticSource((256, 512, 3), num_frames=4, seed=k))
               for k in range(2)]
    for got in grids:
        ref = fusion.update(np.asarray(jrig(np.stack([next(s)
                                                      for s in sources]))))
        np.testing.assert_array_equal(got, ref)


def test_serve_rig_refuses_unmatched_cameras(calibs):
    cli = load_script("torch_serve_rig")
    with pytest.raises(SystemExit):
        cli.parse_args(["--calibs", *calibs, "--cameras", "0", "1"])


def test_export_cli_exports_inspects_and_smokes(tmp_path, capsys):
    cli = load_script("torch_export_model")
    out = tmp_path / "enet.bcseg"
    meta = cli.run(cli.parse_args(["--model", "enet", "--out", str(out),
                                   "--device", "cpu"]))
    assert out.exists() and out.stat().st_size > 0
    printed = json.loads(capsys.readouterr().out.rsplit("wrote", 1)[0])
    assert printed == meta
    assert meta["kind"] == "engine" and meta["fn"] == "predict"
    assert meta["input_hw"] == [256, 512] and meta["platforms"] == ["cpu"]
    # --load inspection, then one zero batch through the program
    loaded = cli.run(cli.parse_args(["--load", str(out), "--smoke"]))
    assert loaded["model"] == "enet"
    assert loaded["smoke_outputs"] == [[[1, 256, 512], "uint8"]]


def test_export_cli_respects_checkpoint_config(tmp_path):
    """A checkpoint trained at a non-default resolution freezes at that
    resolution (the config rides in the checkpoint)."""
    from bugcar_image_segmentation_tpu_torch import ModelConfig
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.utils.checkpoint import \
        save_variables
    ck = tmp_path / "small.msgpack"
    save_variables(str(ck), random_enet_variables(0), ModelConfig(
        input_width=96, input_height=64, dtype="float32"))
    cli = load_script("torch_export_model")
    meta = cli.run(cli.parse_args([
        "--model", "enet", "--checkpoint", str(ck), "--out",
        str(tmp_path / "small.bcseg"), "--platforms", "cpu"]))
    assert meta["input_hw"] == [64, 96], meta


@pytest.mark.parametrize("argv", [["--spatial", "2", "--calibration",
                                   "cal.json"],
                                  ["--platforms", "tpu"],
                                  ["--platforms", "cuda,cpu"], []])
def test_export_cli_refusals(argv, tmp_path):
    cli = load_script("torch_export_model")
    out = [] if argv == [] else ["--out", str(tmp_path / "x.bcseg")]
    with pytest.raises(SystemExit):
        cli.parse_args(["--model", "enet", *argv, *out])
