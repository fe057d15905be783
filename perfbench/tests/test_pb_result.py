"""A run's last line has the contract's keys, and nothing it runs loads
JAX or the JAX package (by whole top-level module name)."""

import json
import os
import subprocess
import sys

import pytest

from perfbench import run
from perfbench.tests.conftest import REPO

REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}
OURS = {"card", "trace_notes", "breakdown", "check_s", "numbers", "checked"}
DEVICE = {"platform", "kind", "count", "memory_peak_bytes"}


def _check_line(r, trace):
    assert REQUIRED <= set(r) and set(r) <= REQUIRED | OURS
    assert list(r)[-1] == "checked"        # the numbers compared come last
    assert all(set(v) == {"value", "limit"} for v in r["checked"].values())
    want = DEVICE | ({"busy_s", "window_s"} if trace else set())
    assert set(r["device"]) == want
    assert all(set(m) == {"value", "unit"} for m in r["metrics"].values())
    assert isinstance(r["correct"], bool)
    if trace:
        b = r["breakdown"]
        assert set(b) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in b.values())


def test_last_line_keys(tiny_root):
    m = tiny_root / "BENCHMARK.json"
    r0 = run.run("tiny_seg.live", 3, 0.5, False, "cpu", m)
    _check_line(r0, False)
    assert set(r0["metrics"]) == {"grid_latency_p95_ms", "grid_latency_p50_ms",
                                  "setup_s"}
    r1 = run.run("tiny_seg.live", 3, 0.5, True, "cpu", m)
    _check_line(r1, True)
    assert "mfu_pct.live" in r1["metrics"]


def _cli(root, trace, env=None):
    """One tiny cell end to end in a fresh interpreter, through the CLI;
    (completed process, top-level modules loaded at its end)."""
    code = (
        "import json, sys\n"
        "from perfbench import run\n"
        f"run.main(['--workload', 'tiny_seg.stream', '--seed', '3000000019',"
        f" '--seconds', '0.5', '--trace', '{trace}', '--device', 'cpu',"
        f" '--manifest', {str(root / 'BENCHMARK.json')!r}])\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600,
                          env=env)


@pytest.mark.parametrize("trace", [0, 1])
def test_no_jax_module_is_loaded(tiny_root, trace):
    """With ``--trace 1`` the per-layer readers and the kernels' costs
    are loaded too."""
    out = _cli(tiny_root, trace)
    assert out.returncode == 0, out.stderr[-2000:]
    result, loaded = out.stdout.strip().splitlines()[-2:]
    result = json.loads(result)
    assert result["attempted"] > 0
    if trace:
        assert "mfu_pct.stream" in result["metrics"]
    loaded = set(json.loads(loaded))
    assert "bugcar_image_segmentation_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax",
                         "bugcar_image_segmentation_tpu"}


def test_a_reader_that_loads_jax_gets_no_result(tiny_root, tmp_path):
    """A module named ``jax`` loaded by a metric reader, after the window
    has closed, still keeps the run from printing a result."""
    fake = tmp_path / "fake"
    (fake / "jax").mkdir(parents=True)
    (fake / "jax" / "__init__.py").write_text("")
    reader = tiny_root / "perfbench" / "metrics" / "mfu_pct.py"
    reader.write_text("import jax\n\n\ndef read(ctx, name):\n"
                      "    return 1.0\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(fake), str(REPO), os.environ.get("PYTHONPATH", "")]))
    out = _cli(tiny_root, 1, env)
    assert out.returncode != 0
    assert "jax" in out.stderr
    assert not any(line.startswith("{\"correct\"")
                   for line in out.stdout.splitlines())


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxtyping_lookalike", sys)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "bugcar_image_segmentation_tpu.x", sys)
    assert run.loaded_forbidden() == ["bugcar_image_segmentation_tpu"]
