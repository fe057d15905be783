"""The window's statistics take every sample: a stall injected into a
fake program moves the tail and the rate, and the rate is every grid over
every second of the window."""

import time

import numpy as np
import torch

from perfbench import stats, traffic
from perfbench.tests.conftest import BENCH

GRID = torch.zeros((4, 4), dtype=torch.int8)


class FakePipe:
    """Takes ``step_s`` a frame, and ``stall_s`` every ``every``-th one."""

    def __init__(self, step_s, stall_s=0.0, every=0):
        self.step_s, self.stall_s, self.every, self.calls = (step_s, stall_s,
                                                             every, 0)

    def _wait(self):
        self.calls += 1
        stall = self.every and self.calls % self.every == 0
        time.sleep(self.stall_s if stall else self.step_s)

    def __call__(self, frame):
        self._wait()
        return GRID

    def stream(self, frames, depth, sync_chunk, transfer_batch):
        for _ in frames:
            self._wait()
            yield GRID.numpy()


def _live(pipe, seconds=0.6):
    pool = np.zeros((2, 2, 4, 4, 3), np.uint8)
    mix = {"warmup": 1}
    out, done = traffic.run_live([pipe, pipe], pool, mix,
                                 [("window", seconds)], lambda p: None,
                                 lambda p: None)
    return out["window"], done


def test_live_tail_and_rate_take_every_frame():
    calm, done = _live(FakePipe(0.002))
    stalled, _ = _live(FakePipe(0.002, 0.03, every=10))
    assert len(calm["latencies_s"]) == calm["grids"] == len(done.grids)
    assert done.offered == calm["grids"]
    p95 = [stats.percentile(w["latencies_s"], 95) for w in (calm, stalled)]
    assert p95[1] > 5 * p95[0]
    rate = [w["grids"] / w["seconds"] for w in (calm, stalled)]
    assert rate[1] < 0.6 * rate[0]
    # every frame of the window, the stalled ones too
    assert max(stalled["latencies_s"]) >= 0.03


def test_stream_rate_counts_whole_drains_over_the_whole_window():
    pool = np.zeros((1, 3, 4, 4, 3), np.uint8)
    mix = {"warmup": 1, "sync_chunk": 2, "transfer_batch": 2, "depth": 2}
    runs = []
    for pipe in (FakePipe(0.002), FakePipe(0.002, 0.05, every=20)):
        out, done = traffic.run_stream([pipe], pool, mix, [("window", 0.5)],
                                       lambda p: None, lambda p: None)
        w = out["window"]
        assert w["grids"] % 4 == 0 and w["seconds"] >= 0.5
        assert done.offered == len(done.grids) >= w["grids"]
        runs.append(w["grids"] / w["seconds"])
    assert runs[1] < 0.8 * runs[0]


def test_percentile_and_union():
    xs = list(range(1, 101))
    assert stats.percentile(xs, 50) == 50.5
    assert abs(stats.percentile(xs, 95) - 95.05) < 1e-9
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.gaps([(0, 2), (1, 3), (5, 6)], 0, 8) == [(3, 5), (6, 8)]


def test_grid_latency_readers_read_the_whole_window():
    from perfbench import manifest

    class Ctx:
        window = {"latencies_s": [0.01] * 90 + [0.1] * 10, "grids": 100,
                  "seconds": 2.0}
    p95 = manifest.reader("grid_latency_p95_ms", BENCH).read(Ctx, "x")
    p50 = manifest.reader("grid_latency_p50_ms", BENCH).read(Ctx, "x")
    assert abs(p95 - 100.0) < 1e-9 and abs(p50 - 10.0) < 1e-9
    assert manifest.reader("grids_per_s", BENCH).read(Ctx, "x") == 50.0
