"""The tiny root of ``tests/conftest.py`` holds one configuration.

``tests/conftest.tiny_manifest`` renames the real manifest's
configurations through a table that knows SegFormer-B0 alone, and raises
on any other.  Until that table drops what it does not know, the tiny
root is built here from the real manifest with every other configuration
taken out, with its cells and the cells' names in the metrics' lists: a
metric left with no cell goes too.  The Xception cell runs at its own
tiny size in ``tests/test_pb_xception.py``.
"""

import json

import pytest

from perfbench.tests import conftest as tiny

KEPT = {"segformer_b0_1024x2048"}


def kept_manifest(real: dict) -> dict:
    cells = {w["name"] for w in real["workloads"] if w["config"] in KEPT}
    out = dict(real, configs=[c for c in real["configs"]
                              if c["name"] in KEPT],
               workloads=[w for w in real["workloads"]
                          if w["name"] in cells])
    for key in ("end_to_end", "per_layer"):
        out[key] = []
        for m in real[key]:
            if "workloads" in m:
                m = dict(m, workloads=[w for w in m["workloads"]
                                       if w in cells])
                if not m["workloads"]:
                    continue
            out[key].append(m)
    return out


@pytest.fixture(autouse=True)
def one_configuration(tmp_path_factory, monkeypatch):
    real = json.loads((tiny.REPO / "BENCHMARK.json").read_text())
    if {c["name"] for c in real["configs"]} <= KEPT:
        return
    root = tmp_path_factory.mktemp("manifest")
    (root / "BENCHMARK.json").write_text(json.dumps(kept_manifest(real)))
    monkeypatch.setattr(tiny, "REPO", root)
