"""Fixtures of the benchmark's CPU tests: a temporary checkout root
holding a manifest of tiny cells (``data/``) beside the benchmark's own
readers, costs and traffic mixes.

Run them with ``python -m pytest -p no:cacheprovider perfbench/tests``;
the tests marked ``cuda`` run on the card and skip without one.
"""

import json
import shutil
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
BENCH = HERE.parent
REPO = BENCH.parent
TINY = {"tiny_seg.live": ("tiny_seg", "live"),
        "tiny_seg.stream": ("tiny_seg", "stream")}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA CUDA card; skipped without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_manifest(limits: dict) -> dict:
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    rename = {"segformer_b0_1024x2048": "tiny_seg"}

    def tiny(name):
        for a, b in rename.items():
            name = name.replace(a, b)
        return name

    real["configs"] = [dict(c, name=rename[c["name"]],
                            file=f"perfbench/configs/{rename[c['name']]}.json")
                       for c in real["configs"]]
    real["workloads"] = [dict(w, name=tiny(w["name"]),
                              config=tiny(w["config"]))
                         for w in real["workloads"]]
    for m in real["end_to_end"] + real["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [tiny(w) for w in m["workloads"]]
    return real


def make_root(tmp: Path) -> Path:
    """A checkout root with the tiny manifest, configs and limits."""
    bench = tmp / "perfbench"
    for sub in ("metrics", "costs", "traffic"):
        shutil.copytree(BENCH / sub, bench / sub)
    (bench / "configs").mkdir()
    for name in ("tiny_seg",):
        shutil.copy(HERE / "data" / f"{name}.json", bench / "configs")
    limits = json.loads((HERE / "data" / "tiny_limits.json").read_text())
    (bench / "limits").mkdir()
    for cell, lim in limits.items():
        (bench / "limits" / f"{cell}.json").write_text(json.dumps(lim))
    (tmp / "BENCHMARK.json").write_text(json.dumps(tiny_manifest(limits)))
    return tmp


@pytest.fixture
def tiny_root(tmp_path) -> Path:
    return make_root(tmp_path)
