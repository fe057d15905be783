"""The one traffic generator: a mix file's parameters → frames offered to
the program, phase by phase.

A mix (``traffic/<mix>.json``) gives:

- ``loop``: ``"live"`` (a closed loop with one frame in flight: each step
  takes the next camera's newest frame, calls ``pipe(frame)`` and waits
  for the int8 grid on the host) or ``"stream"`` (recorded video through
  ``Pipeline.stream``; the source always has a frame);
- ``yaws``: one camera per entry, each turned by its yaw (radians);
  cameras are served in turn;
- ``frames_per_camera``: the distinct frames each camera cycles through;
- ``warmup``: live steps per camera, or stream drains, run before the
  window (they warm every shape the window uses);
- for ``"stream"``: ``depth``, ``sync_chunk`` and ``transfer_batch``, as
  ``Pipeline.stream`` takes them.

The camera size comes from the configuration.  A phase is ``("window",
seconds)`` or ``("traced", seconds)``; each returns what it delivered
and how long it took.  A stream window starts and ends at a drain (one
device→host copy of ``sync_chunk`` dispatches), so its rate counts whole
drains over all the time between them.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Tuple

import numpy as np

from . import frames


def camera_pool(traffic: dict, cfg: dict, seed: int, device) -> np.ndarray:
    """(cameras, frames_per_camera, H, W, 3) uint8 host frames."""
    cam = (cfg["camera"]["height"], cfg["camera"]["width"])
    n, k = len(traffic["yaws"]), traffic["frames_per_camera"]
    return frames.pool(seed, n * k, cam, device).reshape((n, k) + cam + (3,))


class Delivered:
    """Every grid delivered after the warm-up, with the (camera, frame)
    it answers."""

    def __init__(self):
        self.keys: List[Tuple[int, int]] = []
        self.grids: List[np.ndarray] = []
        self.offered = 0

    def add(self, key: Tuple[int, int], grid: np.ndarray) -> None:
        self.keys.append(key)
        self.grids.append(grid)


Hook = Callable[[str], None]


def run_live(pipes, pool: np.ndarray, traffic: dict, phases, begin: Hook,
             end: Hook) -> Tuple[Dict[str, dict], Delivered]:
    cams, per = pool.shape[0], pool.shape[1]
    out: Dict[str, dict] = {}
    done = Delivered()
    i = 0

    def step(record: bool) -> float:
        nonlocal i
        cam, j = i % cams, (i // cams) % per
        i += 1
        t0 = time.perf_counter()
        grid = pipes[cam](pool[cam, j]).cpu()
        took = time.perf_counter() - t0
        if record:
            done.offered += 1
            done.add((cam, j), grid.numpy())
        return took

    for _ in range(traffic["warmup"] * cams):
        step(False)
    for name, seconds in phases:
        begin(name)
        lat: List[float] = []
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            lat.append(step(True))
        out[name] = {"seconds": time.perf_counter() - t0,
                     "grids": len(lat), "latencies_s": lat}
        end(name)
    return out, done


def run_stream(pipes, pool: np.ndarray, traffic: dict, phases, begin: Hook,
               end: Hook) -> Tuple[Dict[str, dict], Delivered]:
    pipe, per = pipes[0], pool.shape[1]
    chunk = traffic["sync_chunk"] * traffic["transfer_batch"]
    state = {"stop": False, "offered": 0}

    def source():
        while not state["stop"]:
            yield pool[0, state["offered"] % per]
            state["offered"] += 1

    grids = pipe.stream(source(), depth=traffic["depth"],
                        sync_chunk=traffic["sync_chunk"],
                        transfer_batch=traffic["transfer_batch"])
    out: Dict[str, dict] = {}
    done = Delivered()
    n = 0

    def take(record: bool) -> None:
        nonlocal n
        grid = next(grids)
        if record:
            done.add((0, n % per), grid)
        n += 1

    for _ in range(traffic["warmup"] * chunk):
        take(False)
    warm = n
    for name, seconds in phases:
        begin(name)
        t0, first = time.perf_counter(), n
        while True:
            take(True)
            if n % chunk == 0 and time.perf_counter() - t0 >= seconds:
                break
        out[name] = {"seconds": time.perf_counter() - t0,
                     "grids": n - first}
        end(name)
    state["stop"] = True
    for grid in grids:                      # what is still in flight
        done.add((0, n % per), grid)
        n += 1
    done.offered = state["offered"] - warm
    return out, done


LOOPS = {"live": run_live, "stream": run_stream}
