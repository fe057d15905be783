"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m perfbench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up: weights from the seed on the device (``weights.py``), their
BatchNorm statistics taken from one seeded calibration frame
(``reference/``), the port's engine and one ``Pipeline`` per camera over
them (``program.py``), a pool of camera frames from the seed
(``frames.py``), and the mix's warm-up of every shape the window uses.
Then the window: ``--seconds`` of the mix (``traffic.py``).  With
``--trace 1`` the same window is followed by a traced one
(``trace.py``), and the cell's per-layer metrics are printed instead of
its end-to-end ones.  Once the windows have closed: the device's memory
peak, a check that no JAX module was loaded, the program freed, and
every delivered grid judged against the plain reference (``check.py``);
the same check once more after the metric readers have run, before the
result is printed.

The last line of standard output is the result as one JSON object; the
numbers compared, each beside its limit, are the last lines of standard
error.  Without a CUDA card, or with fewer than the cell asks for, or
with a module of JAX or the JAX package loaded, the run prints no result
and exits 1.  ``--device cpu`` and ``--manifest``
are for the benchmark's own tests (a rehearsal at a tiny size on the
CPU); the result then names the CPU as its platform.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "bugcar_image_segmentation_tpu")
TRACE_SECONDS = 3.0


def process_start() -> float:
    """Wall-clock time at which this process started."""
    try:
        with open("/proc/self/stat") as f:
            ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return time.time() - (up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


T0 = process_start()


def loaded_forbidden() -> List[str]:
    """Modules of JAX, Flax or the JAX package, by whole top-level name."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What the metric readers read."""

    def __init__(self, cell, base: Path):
        self.cell, self.cfg, self.base = cell, cell.config, base
        self.setup_s = 0.0
        self.window: Dict = {}
        self.trace = None
        self.notes: Dict[str, dict] = {}


def calibrate_statistics(module, raw, cfg: dict, seed: int, dev) -> None:
    """Set the BatchNorm running statistics in ``raw`` to those of one
    seeded calibration frame through the reference, as a trained model's
    statistics follow its data (random ones leave the logits' classes
    nearly tied)."""
    import torch

    from . import frames, reference

    hw = (cfg["camera"]["height"], cfg["camera"]["width"])
    calib = frames.pool(seed, 1, hw, dev, stream=3)
    with torch.no_grad(), reference.common.exact_f32():
        x = reference.grid.preprocess(
            torch.as_tensor(calib, device=dev),
            (cfg["input_height"], cfg["input_width"]), cfg["image_mean"],
            cfg["image_std"])
        module.Model(raw, cfg, reference.common.Precision("f32"),
                     calibrate=True)(x)


def inputs(cell, seed: int, dev):
    """What both sides are handed, from the seed: the raw weights (with
    their calibrated statistics) and the pool of camera frames."""
    from . import reference, traffic
    from . import weights as seeded

    cfg = cell.config
    module = reference.model_module(cfg["reference"])
    raw = seeded.make(module.layout(cfg), seed, dev)
    calibrate_statistics(module, raw, cfg, seed, dev)
    return raw, traffic.camera_pool(cell.traffic, cfg, seed, dev)


def refuse_forbidden() -> None:
    """Exit without a result if JAX or the JAX package was loaded."""
    forbidden = loaded_forbidden()
    if forbidden:
        raise SystemExit(f"modules of JAX or the JAX package were loaded: "
                         f"{forbidden}")


def run(workload: str, seed: int, seconds: float, trace: bool,
        device: str = "cuda", manifest_path: Optional[Path] = None,
        t0: Optional[float] = None) -> dict:
    """One run of a cell; the result object (``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device``, ...)."""
    import torch

    from . import check, manifest, program, traffic
    from . import trace as tracing

    t0 = T0 if t0 is None else t0
    root = manifest_path.parent if manifest_path else manifest.ROOT
    base = root / "perfbench"
    cell = manifest.Cell(manifest.load(manifest_path), workload, root, base)
    if device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA card: torch.cuda.is_available() is "
                             "false")
        if torch.cuda.device_count() < cell.chips:
            raise SystemExit(f"{cell.name} asks for {cell.chips} cards, "
                             f"{torch.cuda.device_count()} found")
    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    ctx = Context(cell, base)

    # -- set-up: inputs from the seed, then the program over them --------
    raw, pool = inputs(cell, seed, dev)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    eng = program.engine(cfg, raw, dev)
    pipes = program.pipelines(eng, cfg, mix["yaws"])
    spans = program.Spans(pipes) if trace else None
    window = tracing.Window(dev) if trace else None
    marks = [0, 0]

    def begin(phase: str) -> None:
        if phase == "window":
            ctx.setup_s = time.time() - t0
            # what set-up made lives on: later collections skip it
            gc.freeze()
        else:
            marks[:] = [spans.frames, spans.calls]
            window.start()

    def end(phase: str) -> None:
        if phase == "traced":
            ctx.trace = window.stop(spans.frames - marks[0],
                                    spans.calls - marks[1])

    phases = [("window", seconds)]
    if trace:
        phases.append(("traced", min(TRACE_SECONDS, seconds)))
    out, done = traffic.LOOPS[mix["loop"]](pipes, pool, mix, phases, begin,
                                           end)
    ctx.window = out["window"]
    refuse_forbidden()
    peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0

    # -- the program is freed; the reference judges what it delivered ---
    del pipes, eng, spans, window
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    refs = check.reference_grids(cfg, mix["yaws"], raw, pool, dev)
    numbers = check.compare(done.keys, done.grids, refs)
    check_s = time.perf_counter() - t_check
    failed = done.offered - len(done.grids)
    correct, rows = check.verdict(numbers, cell.limits, failed)

    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        rd = manifest.reader(m["name"], ctx.base)
        value = None if rd is None else rd.read(ctx, m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev_info = {"platform": "gpu" if device == "cuda" else device,
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else device),
                "count": cell.chips if device == "cuda" else 0,
                "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": int(done.offered),
              "failed": int(failed), "metrics": metrics, "device": dev_info}
    if ctx.trace is not None:
        t = ctx.trace
        dev_info["busy_s"] = t.busy_s
        dev_info["window_s"] = t.window_s
        result["breakdown"] = {"device_ops": [list(x) for x in t.device_ops],
                               "idle_gaps": [list(x) for x in t.idle_gaps]}
        result["trace_notes"] = {"frames": t.frames, "calls": t.calls,
                                 "unlinked_kernel_s": t.unlinked_kernel_s,
                                 "roofline": ctx.notes}
    if device == "cuda":
        from . import peaks
        result["card"] = peaks.card()
    result["check_s"] = check_s
    result["numbers"] = numbers
    result["checked"] = rows
    # the readers, costs, peaks and the check were loaded after the window
    refuse_forbidden()
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--manifest", type=Path, default=None)
    args = p.parse_args(argv)
    result = run(args.workload, args.seed, args.seconds, bool(args.trace),
                 args.device, args.manifest)
    for name, row in result["checked"].items():
        print(f"check {name}: {row['value']} (limit {row['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
