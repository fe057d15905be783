"""The port's host CLIs against the JAX package's scripts
(tests/test_scripts.py's headless paths), on the same arguments.

- ``torch_calibrate.py``: the calibration JSON of corner mode and of
  edge mode equals scripts/calibrate.py's, key for key; edge mode and
  shuffled corners give corner mode's matrix; no mode is an error.
- ``torch_test_straight_line.py``: the same report line and the same
  check image, byte for byte (both draw with cv2 here).
- ``torch_evaluate_model.py``: the metrics of scripts/evaluate_model.py
  on a tiny dataset (two synthetic road scenes as PNG files and their
  labels), with the trained ENet checkpoint.
- ``torch_demo.py``: the demo's grid is scripts/demo.py's, and so are
  its printed cell counts.
- ``torch_bench_train.py --device cpu`` at a tiny size (its resolution
  table replaced) prints one line a model.

The JAX scripts run in this process (``runpy``, ``sys.argv`` set for
them), the port's through their ``run``; the missing-mode error runs the
port's script as a program.  Both engines serve the checkpoint in its
own dtype, bfloat16, on the CPU: their metrics agree within 1e-3
(measured 5.3e-5: 7 of the 262,144 labels flip at bf16 near-ties) and
the demo's grids exactly.
"""

import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CKPT = os.path.join(REPO, "checkpoints", "enet_synthetic.msgpack")
CAL = ["--input-size", "512x256", "--output-size", "512x512",
       "--dist2target", "5,110", "--tile-length", "60", "--cm-per-px", "2",
       "--yaw", "0.12"]
CORNERS = ["210,170", "305,168", "330,235", "185,242"]
METRIC_ATOL = 1e-3


def port_script(name):
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import importlib
        return importlib.import_module(name)
    finally:
        sys.path.pop(0)


def run_jax(monkeypatch, capsys, script, *argv):
    """scripts/<script>.py of the JAX package in this process; its exit
    code and standard output."""
    capsys.readouterr()
    monkeypatch.setattr(sys, "argv", [script] + list(argv))
    with pytest.raises(SystemExit) as done:
        runpy.run_path(os.path.join(REPO, "scripts", f"{script}.py"),
                       run_name="__main__")
    return done.value.code, capsys.readouterr().out


def run_port(capsys, script, *argv):
    capsys.readouterr()
    mod = port_script(script)
    code = mod.main(list(argv))
    return code, capsys.readouterr().out


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("mode", ["corners", "edges"])
def test_calibration_json_equals_jax(monkeypatch, capsys, tmp_path, mode):
    if mode == "corners":
        args = ["--corners", *CORNERS]
    else:
        pts = np.array([[float(v) for v in c.split(",")] for c in CORNERS])
        edges = []
        for i in range(4):
            a, b = pts[i], pts[(i + 1) % 4]
            edges += [a + 0.2 * (b - a), a + 0.8 * (b - a)]
        args = ["--edges"] + [f"{p[0]},{p[1]}" for p in edges]
    got, want = tmp_path / "port.json", tmp_path / "jax.json"
    assert run_port(capsys, "torch_calibrate", *args, *CAL, "--out",
                    str(got))[0] == 0
    assert run_jax(monkeypatch, capsys, "calibrate", *args, *CAL, "--out",
                   str(want))[0] == 0
    got, want = json.loads(got.read_text()), json.loads(want.read_text())
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(np.asarray(got[key]),
                                      np.asarray(want[key]), err_msg=key)


def test_shuffled_corners_and_edges_give_one_matrix(capsys, tmp_path):
    shuffled = [CORNERS[i] for i in (2, 0, 3, 1)]
    out = {}
    for name, args in (("corners", CORNERS), ("shuffled", shuffled)):
        path = tmp_path / f"{name}.json"
        run_port(capsys, "torch_calibrate", "--corners", *args, *CAL,
                 "--out", str(path))
        out[name] = np.asarray(json.loads(path.read_text())["bev matrix"])
    np.testing.assert_allclose(out["shuffled"], out["corners"], atol=1e-6)


def test_missing_mode_errors(tmp_path):
    r = subprocess.run([sys.executable,
                        os.path.join(REPO, "scripts", "torch_calibrate.py"),
                        "--out", str(tmp_path / "x.json")],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 2 and "need --corners/--edges" in r.stderr
    assert not (tmp_path / "x.json").exists()


def test_straight_line_report_equals_jax(monkeypatch, capsys, tmp_path):
    calib = tmp_path / "calib.json"
    run_port(capsys, "torch_calibrate", "--corners", *CORNERS, *CAL,
             "--out", str(calib))
    got_png, want_png = tmp_path / "port.png", tmp_path / "jax.png"
    code, got = run_port(capsys, "torch_test_straight_line", "--calib",
                         str(calib), "--out", str(got_png))
    assert code == 0
    code, want = run_jax(monkeypatch, capsys, "test_straight_line",
                         "--calib", str(calib), "--out", str(want_png))
    assert code == 0
    assert got.replace(str(got_png), "X") == want.replace(str(want_png), "X")
    assert float(got.split("deviation")[1].split("px")[0]) < 1e-6
    assert got_png.read_bytes() == want_png.read_bytes()


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    import cv2

    from bugcar_image_segmentation_tpu_torch import synthetic
    root = tmp_path_factory.mktemp("eval")
    (root / "imgs").mkdir(), (root / "lbls").mkdir()
    for i in range(2):
        frame, label = synthetic.road_scene(np.random.default_rng(30 + i),
                                            (48, 96))
        cv2.imwrite(str(root / "imgs" / f"{i}.png"), frame)
        cv2.imwrite(str(root / "lbls" / f"{i}.png"), label.astype(np.uint8))
    return str(root / "imgs"), str(root / "lbls")


def test_evaluate_metrics_equal_jax(monkeypatch, capsys, dataset):
    imgs, lbls = dataset
    args = ["--model", "enet", "--checkpoint", CKPT, "--images", imgs,
            "--labels", lbls]
    mod = port_script("torch_evaluate_model")
    got = mod.run(mod.parse_args(args + ["--device", "cpu"]))
    code, out = run_jax(monkeypatch, capsys, "evaluate_model", *args)
    assert code == 0
    want = json.loads(out)
    assert sorted(got) == sorted(want)
    assert got["pixel_accuracy"] > 0.9, got
    for key in want:
        np.testing.assert_allclose(got[key], want[key], atol=METRIC_ATOL,
                                   err_msg=key)


def test_demo_grid_equals_jax(monkeypatch, capsys, tmp_path):
    mod = port_script("torch_demo")
    capsys.readouterr()
    grid, seg = mod.run(mod.parse_args(
        ["--checkpoint", CKPT, "--out", str(tmp_path / "port.png"),
         "--device", "cpu"]))
    got = capsys.readouterr().out
    code, want = run_jax(monkeypatch, capsys, "demo", "--checkpoint", CKPT,
                         "--out", str(tmp_path / "jax.png"))
    assert code == 0
    assert got.split("grid cells")[1] == want.split("grid cells")[1]
    assert grid.shape == (80, 80) and {0, 100} <= set(np.unique(grid))
    import cv2
    g = cv2.imread(str(tmp_path / "port.png"))
    j = cv2.imread(str(tmp_path / "jax.png"))
    h = g.shape[0]
    # the grid panel (the last h columns) is the same picture
    np.testing.assert_array_equal(g[:, -h:], j[:, -h:])


def test_bench_train_runs_on_the_cpu(monkeypatch, capsys):
    mod = port_script("torch_bench_train")
    monkeypatch.setattr(mod, "SHAPES", {})          # a tiny resolution
    monkeypatch.setattr(mod, "DEFAULT_HW", (32, 32))
    # iteration counts far enough apart that the slope stays positive on
    # a loaded host (1 and 2 gave a non-positive one under six workers)
    code, out = run_port(capsys, "torch_bench_train", "--models", "enet",
                         "deeplab_xception", "--batches", "2", "--iters",
                         "1", "5", "--device", "cpu")
    assert code == 0
    lines = out.strip().splitlines()
    assert [ln.split()[0] for ln in lines] == ["enet", "deeplab_xception"]
    for ln in lines:
        assert "batch   2 @ 32x32" in ln and "img/s" in ln, ln
