"""Temporal occupancy fusion: accumulate evidence across frames.

Port of ``bugcar_image_segmentation_tpu/fusion.py``, the log-odds
temporal filter over the pipeline's int8 grids:

    odds_t = clip(decay * odds_{t-1} + obs_t)

where a grid (int8 {-1, 0, 100}) maps to observation increments (unknown
→ 0, free → -step, occupied → +step).  Rendering back to the same int8
alphabet is evidence-gated both ways: occupied only above
``occupied_threshold``, free only below ``-free_threshold``; evidence that
merely decayed renders unknown, never free, and cells never observed stay
-1.

:func:`fuse_step` and :func:`translate_state` are torch functions over a
:class:`FusionState` on any device; :class:`TemporalGridFusion` keeps the
state for a stream, on the host in numpy (``backend="numpy"``, the
default: the grid is already on the host there, and an 80x80 elementwise
update costs less than a device round trip) or in torch on ``device``
(``backend="torch"``, "cuda" unless the caller passes "cpu").  Both
backends compute the same f32 values.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch


@dataclasses.dataclass
class FusionState:
    """Carry of the temporal filter."""

    odds: torch.Tensor       # float32 (H, W), signed occupancy evidence
    observed: torch.Tensor   # bool (H, W), ever seen inside the FOV

    @classmethod
    def create(cls, shape: Tuple[int, int], device="cuda") -> "FusionState":
        return cls(odds=torch.zeros(shape, dtype=torch.float32,
                                    device=device),
                   observed=torch.zeros(shape, dtype=torch.bool,
                                        device=device))


def fuse_step(state: FusionState,
              grid: torch.Tensor,
              decay: float = 0.9,
              step: float = 1.0,
              max_odds: float = 5.0,
              occupied_threshold: float = 1.5,
              free_threshold: float = 0.25,
              ) -> Tuple[FusionState, torch.Tensor]:
    """One temporal update on the state's device.

    Args:
      state: previous :class:`FusionState` (or ``FusionState.create``).
      grid: int8 (H, W) in {-1 unknown, 0 free, 100 occupied}.
      decay: evidence half-life knob (closer to 1 = longer memory).
      step: evidence increment per observation.
      max_odds: saturation bound.
      occupied_threshold: odds above this render occupied (at the
        defaults two net occupied observations).
      free_threshold: odds below ``-free_threshold`` render free.

    Returns:
      (new state, fused int8 grid in the same {-1, 0, 100} alphabet).
    """
    grid = torch.as_tensor(grid, device=state.odds.device)
    seen = grid != -1
    obs = torch.where(grid == 100, step,
                      torch.where(seen, -step, 0.0)).float()
    odds = torch.clamp(decay * state.odds + obs, -max_odds, max_odds)
    observed = state.observed | seen
    fused = torch.full(grid.shape, -1, dtype=torch.int8, device=grid.device)
    fused[observed & (odds < -free_threshold)] = 0
    fused[observed & (odds > occupied_threshold)] = 100
    return FusionState(odds=odds, observed=observed), fused


def _valid_after_roll(shape: Tuple[int, int], dy: int, dx: int
                      ) -> np.ndarray:
    h, w = shape
    rows = np.arange(h)[:, None] - dy
    cols = np.arange(w)[None, :] - dx
    return (rows >= 0) & (rows < h) & (cols >= 0) & (cols < w)


def translate_state(state: FusionState, dy_cells: int, dx_cells: int
                    ) -> FusionState:
    """Shift accumulated evidence by whole cells (ego-motion compensation).

    The grid is vehicle-anchored (bottom-centre), so when the robot moves
    the world evidence shifts the other way in grid coordinates:
    ``dy_cells > 0`` moves evidence down (the robot moved forward),
    ``dx_cells > 0`` moves it right (the robot moved left).  Cells shifted
    in from outside become unobserved."""
    dy, dx = int(dy_cells), int(dx_cells)
    valid = torch.as_tensor(_valid_after_roll(tuple(state.odds.shape), dy,
                                              dx), device=state.odds.device)
    odds = torch.roll(state.odds, (dy, dx), (0, 1))
    observed = torch.roll(state.observed, (dy, dx), (0, 1))
    return FusionState(odds=torch.where(valid, odds, 0.0),
                       observed=observed & valid)


def _fuse_step_np(odds: np.ndarray, observed: np.ndarray,
                  grid: np.ndarray, decay: float, step: float,
                  max_odds: float, occupied_threshold: float,
                  free_threshold: float):
    """Host-side twin of :func:`fuse_step` (the same math, numpy)."""
    grid = np.asarray(grid)
    seen = grid != -1
    obs = np.where(grid == 100, step,
                   np.where(seen, -step, 0.0)).astype(np.float32)
    odds = np.clip(decay * odds + obs, -max_odds, max_odds)
    observed = observed | seen
    fused = np.full(grid.shape, -1, np.int8)
    fused[observed & (odds < -free_threshold)] = 0
    fused[observed & (odds > occupied_threshold)] = 100
    return odds, observed, fused


def _translate_np(odds: np.ndarray, observed: np.ndarray, dy: int,
                  dx: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side twin of :func:`translate_state`."""
    valid = _valid_after_roll(odds.shape, dy, dx)
    odds = np.roll(odds, (dy, dx), (0, 1))
    observed = np.roll(observed, (dy, dx), (0, 1))
    return np.where(valid, odds, np.float32(0.0)), observed & valid


class TemporalGridFusion:
    """Stateful wrapper over a stream of grids.

    ``backend="numpy"`` (default) runs on the host; ``backend="torch"``
    keeps the state on ``device`` and takes and returns tensors there.
    ``cell_m`` enables ego-motion compensation: ``update(grid,
    motion_m=(forward, left))`` with the robot's metric displacement since
    the previous frame translates the evidence to stay world-aligned
    (fractions of a cell accumulate across frames).
    """

    def __init__(self, shape: Tuple[int, int], decay: float = 0.9,
                 step: float = 1.0, max_odds: float = 5.0,
                 occupied_threshold: float = 1.5,
                 free_threshold: float = 0.25,
                 backend: str = "numpy",
                 cell_m: float = 1.0,
                 device="cuda"):
        if backend not in ("numpy", "torch"):
            raise ValueError(f"unknown backend {backend!r}")
        self.backend = backend
        self.device = torch.device(device)
        self._shape = tuple(shape)
        self._cell_m = float(cell_m)
        self._params = (decay, step, max_odds, occupied_threshold,
                        free_threshold)
        self._residual = np.zeros(2)   # fractional cells (dy, dx)
        self.reset()

    def _motion_to_cells(self, motion_m) -> Tuple[int, int]:
        # forward motion moves world evidence DOWN the grid (+y);
        # leftward motion moves it RIGHT (+x); accumulate fractions.
        fwd, left = motion_m
        self._residual += np.array([fwd, left]) / self._cell_m
        whole = np.trunc(self._residual).astype(int)
        self._residual -= whole
        return int(whole[0]), int(whole[1])

    def update(self, grid, motion_m=None):
        """Fuse one int8 grid; returns the fused grid (numpy, or a tensor
        on the device for the torch backend)."""
        if motion_m is not None:
            dy, dx = self._motion_to_cells(motion_m)
            if dy or dx:
                if self.backend == "torch":
                    self.state = translate_state(self.state, dy, dx)
                else:
                    self._odds, self._observed = _translate_np(
                        self._odds, self._observed, dy, dx)
        if self.backend == "torch":
            decay, step, max_odds, occ, free = self._params
            self.state, fused = fuse_step(
                self.state, grid, decay=decay, step=step, max_odds=max_odds,
                occupied_threshold=occ, free_threshold=free)
            return fused
        self._odds, self._observed, fused = _fuse_step_np(
            self._odds, self._observed, grid, *self._params)
        return fused

    def reset(self) -> None:
        """Forget the evidence (the fractional motion carries over, as in
        the JAX package)."""
        if self.backend == "torch":
            self.state = FusionState.create(self._shape, self.device)
        else:
            self._odds = np.zeros(self._shape, np.float32)
            self._observed = np.zeros(self._shape, bool)


__all__ = ["FusionState", "fuse_step", "translate_state",
           "TemporalGridFusion"]
