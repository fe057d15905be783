"""The readers of the port's spans and counters: a traced run reports every
host metric a CPU can give (``device_backlog`` needs a card), the port
counted the frames the harness counted, and an untraced run records
nothing."""

import pytest

from perfbench import run

HOST = ("upload_host_ms", "engine_host_ms", "grid_host_ms",
        "pipeline_self_ms")
CPU_METRICS = {"tiny_seg.live": [f"{m}.live" for m in HOST],
               "tiny_seg.stream": [f"{m}.stream" for m in HOST]
               + ["drain_wait_ms.stream"]}


@pytest.mark.parametrize("cell", sorted(CPU_METRICS))
def test_a_traced_run_reports_the_port_spans(tiny_root, cell):
    from bugcar_image_segmentation_tpu_torch.utils.profiling import RECORDER

    r = run.run(cell, 3000000019, 0.5, True, "cpu",
                tiny_root / "BENCHMARK.json")
    metrics = r["metrics"]
    for name in CPU_METRICS[cell]:
        assert metrics[name]["value"] > 0, name
        assert metrics[name]["unit"] == "ms/grid"
    assert "device_backlog.stream" not in metrics
    frames = r["trace_notes"]["frames"]
    assert frames > 0 and RECORDER.counters["engine_frames"] == frames
    assert RECORDER.dropped == 0
    # the host metrics partition the pipeline's host time, which lies
    # inside the traced window
    host = sum(metrics[n]["value"] for n in CPU_METRICS[cell][:4])
    assert host <= 1e3 * r["device"]["window_s"] / frames


def test_an_untraced_run_records_nothing(tiny_root):
    from bugcar_image_segmentation_tpu_torch.utils.profiling import (
        RECORDER, recording)

    with recording():
        pass
    r = run.run("tiny_seg.live", 3000000019, 0.5, False, "cpu",
                tiny_root / "BENCHMARK.json")
    assert r["attempted"] > 0
    assert RECORDER.spans() == [] and RECORDER.counters == {}
