"""The frozen plain references against the port's plain path, in float32
at a tiny size: logits within the port's own pinned tolerances (rtol =
atol = 1e-4, ``tests/test_torch_segformer.py``)
and grids equal; and the references' weight layouts are the port's state
dicts."""

import json

import numpy as np
import pytest
import torch

from perfbench import check, frames, program, reference, run, weights
from perfbench.reference import grid as rgrid
from perfbench.reference.common import Precision
from perfbench.tests.conftest import HERE

RTOL = ATOL = 1e-4


def _cfg(name):
    cfg = json.loads((HERE / "data" / f"{name}.json").read_text())
    return dict(cfg, dtype="float32")


def test_reference_equals_the_ports_plain_path():
    cfg = _cfg("tiny_seg")
    module = reference.model_module(cfg["reference"])
    raw = weights.make(module.layout(cfg), 7, "cpu")
    run.calibrate_statistics(module, raw, cfg, 7, "cpu")
    eng = program.engine(cfg, raw, "cpu")
    assert set(eng.module.state_dict()) >= set(raw)
    shapes = {k: tuple(v.shape) for k, v in eng.module.state_dict().items()}
    assert all(shapes[k] == s for k, s in module.layout(cfg))
    yaws = [0.05, 0.3]
    pool = frames.pool(7, 4, (cfg["camera"]["height"], cfg["camera"]["width"]),
                       "cpu").reshape(2, 2, cfg["camera"]["height"],
                                      cfg["camera"]["width"], 3)
    pipes = program.pipelines(eng, cfg, yaws)
    refs = check.reference_grids(cfg, yaws, raw, pool, "cpu")
    model = module.Model(raw, cfg, Precision())
    hw = (cfg["input_height"], cfg["input_width"])
    for c in range(2):
        for j in range(2):
            got = eng.logits(pool[c, j]).numpy()
            x = rgrid.preprocess(torch.as_tensor(pool[c, j:j + 1]), hw,
                                 cfg["image_mean"], cfg["image_std"])
            with torch.no_grad():
                want = model(x)[0].numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
            np.testing.assert_array_equal(pipes[c](pool[c, j]).numpy(),
                                          refs[(c, j)][0])


def test_reference_imports_nothing_of_the_program():
    import ast
    for path in (HERE.parent / "reference").glob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.ImportFrom) and node.level:
                continue                # within reference/
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                for n in names:
                    assert n.split(".")[0] in ("", "__future__", "typing",
                                               "contextlib", "importlib",
                                               "math", "numpy", "torch"), \
                        (path.name, n)
