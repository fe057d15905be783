"""The benchmark's plain Xception-65 DeepLabV3+ reference
(``perfbench/reference/xception.py``) against the port, and the kernels'
launch counters in the span recorder.

The reference and the port's plain path are one function: in float64
their logits agree to 1e-9.  In float32 (the port's plain and ``_fs``
paths, the kernel's plain version on CPU tensors) they cannot agree to
the 1e-4 of ``perfbench/tests/test_pb_reference.py``: through 2 middle
blocks at 64x128 each side's float32 logits lie up to ~1e-3 from the
float64 ones (summation orders, magnified by the BatchNorms), so the
port is held within twice the reference's own float32 distance from
float64, and its grids through ``Pipeline`` equal the reference's.
Seeded weights with calibrated statistics, CPU only.
"""

import ast
import contextlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu_torch.models.xception import \
    Xception65DeepLab
from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
from bugcar_image_segmentation_tpu_torch.ops.cuda import sepconv as sc
from bugcar_image_segmentation_tpu_torch.utils import profiling
from perfbench import check, frames, program, run, weights
from perfbench.reference import grid as rgrid
from perfbench.reference import xception
from perfbench.reference.common import Precision

ROOT = Path(__file__).resolve().parents[1]
FULL = json.loads((ROOT / "perfbench" / "configs"
                   / "xception65_deeplabv3plus_1024x512.json").read_text())
SMALL = dict(json.loads((ROOT / "perfbench" / "tests" / "data"
                         / "tiny_xception.json").read_text()),
             dtype="float32")
SEED = 7
YAWS = [0.05, 0.3]
# float64 sums in other orders: far below any float32 difference
F64_TOL = 1e-9


@pytest.fixture(scope="module")
def seeded():
    """Raw weights with calibrated statistics, a 2 x 2 pool of camera
    frames, and the reference's preprocessed inputs for them."""
    raw = weights.make(xception.layout(SMALL), SEED, "cpu")
    run.calibrate_statistics(xception, raw, SMALL, SEED, "cpu")
    cam = (SMALL["camera"]["height"], SMALL["camera"]["width"])
    pool = frames.pool(SEED, 4, cam, "cpu").reshape((2, 2) + cam + (3,))
    hw = (SMALL["input_height"], SMALL["input_width"])
    x = rgrid.preprocess(torch.as_tensor(pool.reshape((4,) + cam + (3,))),
                         hw, SMALL["image_mean"], SMALL["image_std"])
    return raw, pool, x


def _reference(raw, x, dtype=torch.float32, precision="f32"):
    w = {k: v.to(dtype) for k, v in raw.items()}
    with torch.no_grad():
        return xception.Model(w, SMALL, Precision(precision))(x.to(dtype))


def test_reference_is_the_ports_plain_function_in_float64(seeded):
    raw, pool, x = seeded
    eng = program.engine(dict(SMALL, engine="deeplab_xception",
                              dtype="float64"),
                         {k: v.double() for k, v in raw.items()}, "cpu")
    want = _reference(raw, x, torch.float64)
    got = torch.stack([eng.logits(f) for f in pool.reshape((4,)
                                                           + pool.shape[2:])])
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=F64_TOL,
                               atol=F64_TOL)


@pytest.mark.parametrize("name", ["deeplab_xception", "deeplab_xception_fs"])
def test_the_ports_float32_paths_meet_the_reference(seeded, name):
    """Logits within twice the reference's own float32 distance from
    float64 (measured ~1.4x at most), grids equal."""
    raw, pool, x = seeded
    eng = program.engine(dict(SMALL, engine=name), raw, "cpu")
    exact = _reference(raw, x, torch.float64)
    own = float((_reference(raw, x) - exact).abs().max())
    got = torch.stack([eng.logits(f) for f in pool.reshape((4,)
                                                           + pool.shape[2:])])
    assert got.dtype == torch.float32
    assert float((got.double() - exact).abs().max()) <= 2 * own
    refs = check.reference_grids(SMALL, YAWS, raw, pool, "cpu")
    pipes = program.pipelines(eng, SMALL, YAWS)
    for c in range(2):
        for j in range(2):
            np.testing.assert_array_equal(pipes[c](pool[c, j]).numpy(),
                                          refs[(c, j)][0])


def test_fp8_moves_the_logits_far_beyond_float32(seeded):
    """The control (every product's operands in float8 e4m3) moves the
    logits by orders of magnitude more than float32 rounding does."""
    raw, _, x = seeded
    f32 = _reference(raw, x)
    own = float((f32.double() - _reference(raw, x, torch.float64)).abs()
                .mean())
    fp8 = float((_reference(raw, x, precision="fp8") - f32).abs().mean())
    assert fp8 > 1000 * own
    assert fp8 > 0.01 * float(f32.std())


def test_layout_is_the_ports_state_dict_at_the_published_widths():
    with torch.device("meta"):
        model = Xception65DeepLab(num_classes=FULL["num_classes"],
                                  middle_blocks=FULL["model"]
                                  ["middle_blocks"])
    sd = model.state_dict()
    got = xception.layout(FULL)
    assert [k for k, _ in got] == list(sd)
    assert all(tuple(sd[k].shape) == s for k, s in got)
    assert len(got) == 707
    assert sum(k.endswith(".var") for k, _ in got) == 141


def test_reference_imports_nothing_of_the_port_or_jax():
    tree = ast.parse((ROOT / "perfbench" / "reference" / "xception.py")
                     .read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and not node.level:
            names = [node.module]
        else:
            continue
        assert all(n.split(".")[0] in ("__future__", "typing", "torch")
                   for n in names), names
    code = (
        "import json, sys, torch\n"
        "from perfbench.reference import xception\n"
        f"cfg = json.loads({json.dumps(json.dumps(SMALL))})\n"
        "w = {k: torch.empty(s, device='meta')"
        " for k, s in xception.layout(cfg)}\n"
        "x = torch.empty((1, 64, 128, 3), device='meta')\n"
        "from perfbench.reference.common import Precision\n"
        "xception.Model(w, cfg, Precision())(x)\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300,
                         check=True)
    loaded = set(json.loads(out.stdout.splitlines()[-1]))
    assert not loaded & {"jax", "jaxlib", "flax", "bugcar_image_segmentation_tpu",
                         "bugcar_image_segmentation_tpu_torch"}


@pytest.fixture
def launches():
    """The kernels' launch counts, restored afterwards."""
    saved = dict(kcuda.LAUNCHES)
    yield
    kcuda.LAUNCHES.update(saved)


def test_add_launches_records_counters_only_while_recording(launches):
    with profiling.recording() as rec:
        kcuda.add_launches({("fused_sepconv",): 55,
                            ("halo_add", "tma"): 1})
        kcuda.add_launches({("fused_sepconv",): 55})
        assert rec.counters == {"launches.fused_sepconv": 110}
    before = dict(kcuda.LAUNCHES)
    kcuda.add_launches({("fused_sepconv",): 55})
    assert rec.counters == {"launches.fused_sepconv": 110}   # unchanged
    assert kcuda.LAUNCHES["fused_sepconv"] == before["fused_sepconv"] + 55


class _Library:
    """A stand-in for the kernels' built library: every launch succeeds."""

    def __getattr__(self, name):
        return lambda *args: 0


def test_a_kernel_launch_counts_while_recording(monkeypatch, launches):
    """The sepconv's CUDA implementation on CPU tensors (the device check,
    the stream and the library replaced): each launch adds one to
    ``LAUNCHES`` and, inside ``recording()``, to its counter."""
    monkeypatch.setattr(sc, "_CARD", "cpu")
    monkeypatch.setattr(sc, "_stream", lambda dev: 0)
    monkeypatch.setattr(sc._build, "library", lambda: _Library())
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    c, f = 8, 16
    args = (torch.zeros(2, 16, 32, c), torch.zeros(3, 3, 1, c),
            torch.zeros(c), torch.zeros(c), torch.zeros(c, f),
            torch.zeros(f), torch.zeros(f))
    before = kcuda.LAUNCHES["fused_sepconv"]
    sc.launch(*args, strides=1, act_out=True)
    with profiling.recording() as rec:
        sc.launch(*args, strides=1, act_out=True)
        sc.launch(*args, strides=1, act_out=True)
    assert rec.counters == {"launches.fused_sepconv": 2}
    assert kcuda.LAUNCHES["fused_sepconv"] == before + 3


def test_every_count_site_goes_through_counted():
    """No module of ``ops/cuda`` adds to ``LAUNCHES`` but ``counted``, so
    every launch reaches the recorder."""
    pkg = Path(kcuda.__file__).parent
    writers = []
    for path in pkg.glob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if (isinstance(node, ast.AugAssign)
                    and isinstance(node.target, ast.Subscript)
                    and getattr(node.target.value, "id", "") == "LAUNCHES"):
                writers.append(path.name)
    assert writers == ["__init__.py"]
    for name in ("sepconv.py", "attention.py", "bottleneck.py", "probes.py"):
        assert "counted(" in (pkg / name).read_text(), name
