"""``BENCHMARK.json`` and the files it names, found by name.

- a configuration: the ``file`` its entry names (``configs/<name>.json``);
- a traffic mix: ``traffic/<mix>.json``;
- a metric (end-to-end or per-layer): ``metrics/<name>.py``, or the
  reader of the longest dot-separated prefix of its name
  (``engine_device_ms.live`` → ``metrics/engine_device_ms.py``);
- a kernel's operation and byte counts: ``costs/<kernel>.py``;
- a cell's correctness limits: ``limits/<cell>.json``.

A later change adds a configuration, mix, cell, metric or kernel cost by
adding such files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")


def check_name(name: str) -> str:
    if not NAME.match(name):
        raise ValueError(f"bad name {name!r}")
    return name


def load(path: Optional[Path] = None) -> dict:
    with open(path or ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _module(path: Path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str, base: Path = HERE) -> Optional[ModuleType]:
    """The metric reader for ``name``: ``metrics/<name>.py`` or that of its
    longest dot-separated prefix."""
    parts = check_name(name).split(".")
    for k in range(len(parts), 0, -1):
        path = base / "metrics" / (".".join(parts[:k]) + ".py")
        if path.exists():
            return _module(path)
    return None


def cost(kernel: str, base: Path = HERE) -> ModuleType:
    return _module(base / "costs" / f"{check_name(kernel)}.py")


class Cell:
    """One workload with everything it is run by."""

    def __init__(self, manifest: dict, name: str, root: Path = ROOT,
                 base: Path = HERE):
        by_name = {w["name"]: w for w in manifest["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r}; have {sorted(by_name)}")
        self.workload = w = by_name[name]
        self.name = check_name(name)
        self.chips = int(w["chips"])
        entry = {c["name"]: c for c in manifest["configs"]}[w["config"]]
        with open(root / entry["file"]) as f:
            self.config: dict = json.load(f)
        with open(base / "traffic" / f"{check_name(w['traffic'])}.json") as f:
            self.traffic: dict = json.load(f)
        self.end_to_end = self._mine(manifest["end_to_end"])
        self.per_layer = self._mine(manifest["per_layer"])
        with open(base / "limits" / f"{self.name}.json") as f:
            self.limits: Dict[str, float] = json.load(f)

    def _mine(self, metrics: List[dict]) -> List[dict]:
        return [m for m in metrics
                if "workloads" not in m or self.name in m["workloads"]]
