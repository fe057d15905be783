"""The readings a cell's correctness limits are set from.

    python -m perfbench.readings --workload <cell> --seeds 1 2 3 ... \
        [--seconds 2] [--control-only]

For each seed, in one process: a run of the cell with a short window
(``run.run``: the timed path at the cell's own size and load, every
delivered grid judged), and the control, the plain reference computed
in fp8 in the program's place, judged the same way (one grid per camera
and frame: the program's are the same each time a frame comes back).
One JSON line per reading.  The benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, manifest, run as runner


def control(workload: str, seed: int, device: str = "cuda",
            manifest_path=None) -> dict:
    """The control's numbers on this seed: the fp8 reference's grids
    against the f32 reference's."""
    root = manifest_path.parent if manifest_path else manifest.ROOT
    cell = manifest.Cell(manifest.load(manifest_path), workload, root,
                         root / "perfbench")
    cfg, mix = cell.config, cell.traffic
    dev = torch.device(device)
    raw, pool = runner.inputs(cell, seed, dev)
    refs = check.reference_grids(cfg, mix["yaws"], raw, pool, dev)
    low = check.reference_grids(cfg, mix["yaws"], raw, pool, dev, "fp8")
    keys = sorted(low)
    numbers = check.compare(keys, [low[k][0] for k in keys], refs)
    ok, rows = check.verdict(numbers, cell.limits, 0)
    return {"reading": "control", "workload": workload, "seed": seed,
            "numbers": numbers, "correct": ok}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control-only", action="store_true")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    for seed in args.seeds:
        if not args.control_only:
            r = runner.run(args.workload, seed, args.seconds, False,
                           args.device)
            print(json.dumps({"reading": "program", "workload": args.workload,
                              "seed": seed, "numbers": r["numbers"],
                              "correct": r["correct"],
                              "metrics": r["metrics"]}), flush=True)
        print(json.dumps(control(args.workload, seed, args.device)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
