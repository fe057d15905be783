"""Whether the grids the timed path delivered are correct.

Every grid delivered after the warm-up is compared with the plain
reference's grid of the same camera and frame (``reference/``), worked
out once the window has closed, frame by frame, from the raw weights and
frames the program was given.  The numbers compared:

- ``wide_flip_share``: of the cells of every delivered grid whose proven
  margin is above ``WIDE``, the share that differ.  A cell depends on the
  label pixels under the bilinear taps of the 5x5 template pixels its
  opening reads; if it differs, one of them was labelled otherwise, so
  the program's logits there moved by at least that pixel's margin (the
  gap between the reference's best class and the best class of another
  drivability class, in units of the frame's logit standard deviation).
  The smallest margin among a cell's pixels is what its difference
  proves.  bf16 moves logits that far only now and then, in a single
  cell; a lower precision in many cells of every frame; a wrong,
  misplaced or stale grid in most of its cells, so one such grid in a
  copy of 64 still reads far above the limit.
- ``flip_margin``, reported beside it and not compared: the widest proven
  margin of any differing cell.  It turns on one cell, and swings with
  it from seed to seed.
- ``failed``: frames offered whose grid never came (limit 0).

The limits (``limits/<cell>.json``) are set from sound runs of the
program and from the control, the reference in fp8
(``reference/common.Precision``), as ``PERF.md`` records.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from . import reference
from .reference import grid as rgrid
from .reference.common import Precision, exact_f32

# the margin of a cell that depends on no label pixel (outside the
# camera's view): any difference there is certain
NO_PIXEL = 1000.0
# a cell is wide where its proven margin is above this many logit sd
WIDE = 0.1


def margins(logits: torch.Tensor) -> torch.Tensor:
    """(N, h, w, C) → (N, h*w): the gap from the best class to the best
    class of another drivability class, over the frame's logit sd."""
    drv = torch.full((logits.shape[-1],), 2, dtype=torch.long)
    drv[list(rgrid.FLAT_CLASSES)] = 0
    drv[list(rgrid.ROAD_CLASSES)] = 1
    drv = drv.to(logits.device)
    best = logits.max(-1)
    same = drv[best.indices][..., None] == drv
    other = torch.where(same, torch.full_like(logits, -float("inf")),
                        logits).amax(-1)
    sd = logits.flatten(1).std(1).view(-1, 1, 1)
    return ((best.values - other) / sd).flatten(1)


@torch.no_grad()
def reference_grids(cfg: dict, yaws, weights, pool: np.ndarray, device,
                    precision: str = "f32"
                    ) -> Dict[Tuple[int, int], Tuple[np.ndarray, np.ndarray]]:
    """(camera, frame) → (int8 grid, per-cell margins) by the reference
    computed in ``precision``, one frame at a time."""
    module = reference.model_module(cfg["reference"])
    model = module.Model(weights, cfg, Precision(precision))
    hw = (cfg["input_height"], cfg["input_width"])
    grids = rgrid.grid_references(cfg, yaws, device)
    out = {}
    with exact_f32():
        for c, yaw in enumerate(yaws):
            for j in range(pool.shape[1]):
                x = rgrid.preprocess(torch.as_tensor(pool[c, j:j + 1],
                                                     device=device), hw,
                                     cfg["image_mean"], cfg["image_std"])
                logits = model(x)
                g = grids[yaw]
                grid = g(rgrid.drivability(logits))
                margin = g.cell_margins(margins(logits))[0].clamp(max=NO_PIXEL)
                out[(c, j)] = (grid[0].cpu().numpy(), margin.cpu().numpy())
                del logits
    return out


def compare(keys, delivered, refs) -> Dict[str, float]:
    """The numbers compared, over every delivered grid."""
    worst, wide, wide_differ = 0.0, 0, 0
    by_key: Dict[Tuple[int, int], list] = {}
    for key, grid in zip(keys, delivered):
        by_key.setdefault(key, []).append(grid)
    for key, grids in by_key.items():
        ref, margin = refs[key]
        differ = np.stack(grids) != ref
        sure = margin > WIDE
        wide += int(sure.sum()) * len(grids)
        wide_differ += int((differ & sure).sum())
        if differ.any():
            worst = max(worst, float(margin[differ.any(0)].max()))
    return {"wide_flip_share": wide_differ / max(wide, 1),
            "flip_margin": worst, "grids_checked": len(delivered)}


def verdict(numbers: Dict[str, float], limits: Dict[str, float],
            failed: int) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(correct, each number beside its limit)."""
    rows = {"failed": {"value": failed, "limit": 0}}
    for name, limit in limits.items():
        rows[name] = {"value": numbers[name], "limit": limit}
    ok = (numbers["grids_checked"] > 0
          and all(r["value"] <= r["limit"] for r in rows.values()))
    return ok, rows
