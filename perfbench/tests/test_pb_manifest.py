"""``BENCHMARK.json`` keeps to the benchmark's contract, and every file a
cell runs by is found by name; files added beside them are picked up
with no edit."""

import json
import re
import shutil

from perfbench import manifest, run
from perfbench.tests.conftest import BENCH, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_manifest_keeps_to_the_contract():
    raw = (REPO / "BENCHMARK.json").read_text()
    assert len(raw.encode()) <= 64 * 1024
    m = json.loads(raw)
    assert set(m) == KEYS
    assert m["paths"] == ["perfbench"]
    assert all(_text(w) for w in m["command"]) and len(m["command"]) <= 32
    assert 1 <= m["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    assert ((2 + 14 * 24) * (m["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    names = set()
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text(c["why"]) and _text(c["source"])
        assert c["file"].startswith("perfbench/")
        assert (REPO / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
        names.add(c["name"])
    cells = set()
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] in (1, 4)
        assert _text(w["why"])
        cells.add(w["name"])
    assert len(cells) == len(m["workloads"])
    assert {w["config"] for w in m["workloads"]} == names
    e2e = {}
    for x in m["end_to_end"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
        e2e[x["name"]] = set(x.get("workloads", cells))
    assert e2e["setup_s"] == cells
    seen = set(e2e)
    for x in m["per_layer"]:
        assert set(x) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert _text(x["layer"]) and x["moves"] in e2e
        assert set(x["workloads"]) <= e2e[x["moves"]]
        seen.add(x["name"])
    assert len(seen) == len(m["end_to_end"]) + len(m["per_layer"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert NAME.match(x["name"]) and UNIT.match(x["unit"])
        assert x["better"] in ("lower", "higher")
        assert manifest.reader(x["name"]) is not None
    for cell in cells:
        c = manifest.Cell(m, cell)
        reports = {x["name"] for x in c.end_to_end}
        assert "setup_s" in reports and len(reports) >= 2 and c.per_layer
        for kernel in c.config.get("kernels", []):
            assert manifest.cost(kernel).launches(c.config, 1)


def test_a_cell_added_as_files_runs_with_no_edit(tiny_root):
    """A new mix, metric, kernel cost, cell and its limits: files and
    manifest entries only; the run finds and reports them."""
    bench = tiny_root / "perfbench"
    mix = json.loads((bench / "traffic" / "stream.json").read_text())
    mix.update(depth=4, sync_chunk=2, transfer_batch=2, frames_per_camera=3)
    (bench / "traffic" / "stream_shallow.json").write_text(json.dumps(mix))
    (bench / "metrics" / "offered_per_s.py").write_text(
        "def read(ctx, name):\n"
        "    return ctx.window['grids'] / ctx.window['seconds']\n")
    shutil.copy(bench / "costs" / "flash_attention.py",
                bench / "costs" / "flash_attention_copy.py")
    (bench / "limits" / "tiny_seg.shallow.json").write_text(
        (bench / "limits" / "tiny_seg.stream.json").read_text())
    m = json.loads((tiny_root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "tiny_seg.shallow", "config": "tiny_seg",
                           "traffic": "stream_shallow", "chips": 1,
                           "why": "a test"})
    m["end_to_end"].append({"name": "offered_per_s", "unit": "grids/s",
                            "better": "higher", "bound": 0.05,
                            "source": "host_clock",
                            "workloads": ["tiny_seg.shallow"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(m))
    assert manifest.cost("flash_attention_copy", bench).launches(
        json.loads((bench / "configs" / "tiny_seg.json").read_text()), 2)
    r = run.run("tiny_seg.shallow", 5, 0.5, False, "cpu",
                tiny_root / "BENCHMARK.json")
    assert r["correct"]
    assert set(r["metrics"]) == {"offered_per_s", "setup_s"}
    assert r["metrics"]["offered_per_s"]["unit"] == "grids/s"


def test_every_reader_and_cost_is_found_by_its_own_name():
    for path in (BENCH / "metrics").glob("*.py"):
        assert manifest.reader(path.stem) is not None
    assert manifest.reader("engine_device_ms.some_new_split").__file__ \
        .endswith("engine_device_ms.py")
    assert manifest.reader("no_such_metric") is None
