"""The camera→occupancy-grid pipeline on the device.

Port of ``bugcar_image_segmentation_tpu/pipeline.py`` (``Pipeline``; the
reference's ``inference_video.py`` hot loop, SURVEY.md §3.1):

    uint8 BGR frame → resize/normalize → backbone → argmax → 3-class remap
    → BEV warp → morph-open → cell binning → int8 grid

all on the engine's device; a raw frame goes in and an int8 grid comes
out.  Batches run through the backbone in chunks of at most 4 frames.
``stream()`` keeps ``depth`` frames in flight: CUDA launches are
asynchronous, so the host prepares frame N+1 while the device computes
frame N, and results are fetched ``sync_chunk`` grids per device→host
copy.

This slice carries the JAX pipeline's default transport (``"bgr"`` with
the resize on the device).  The i420 transport, host-side resize, CLAHE,
the contour filter and laserscan grids raise ``NotImplementedError``:
they come with later slices (they need cv2-free replacements on the GPU
host).
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from .configs import CalibrationConfig, GridConfig
from .grid import OccupancyGridBuilder
from .models.api import Engine, frames_to_device

CHUNK = 4   # most frames one backbone batch runs


def _not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (a later slice of the PyTorch port; "
        f"see ROADMAP.md Queue 1)")


class Pipeline:
    """Single-camera frame→grid pipeline.

    Args:
      engine: an :class:`~.models.api.Engine`.
      cal: calibration whose ``input_shape`` (w, h) matches the engine's
        output resolution.
      grid_cfg: metric grid geometry.
      mode: "multiclass" or "binary" (reference bev.py:166 / 97).
      interpolation: warp parity mode (see grid.py).
    """

    def __init__(self,
                 engine: Engine,
                 cal: CalibrationConfig,
                 grid_cfg: GridConfig,
                 mode: str = "multiclass",
                 interpolation: str = "cv2_linear",
                 use_clahe: bool = False,
                 contour_filter: bool = False,
                 host_resize: bool = False,
                 transport: str = "bgr"):
        expect = (cal.input_height, cal.input_width)
        got = (engine.cfg.input_height, engine.cfg.input_width)
        if expect != got:
            raise ValueError(
                f"calibration input_shape (h, w)={expect} must match the "
                f"engine's output resolution {got}")
        if transport not in ("bgr", "i420"):
            raise ValueError(f"unknown transport {transport!r}")
        if transport == "i420":
            raise _not_ported("transport='i420'")
        if host_resize:
            raise _not_ported("host_resize=True")
        if use_clahe:
            raise _not_ported("use_clahe=True")
        if contour_filter:
            raise _not_ported("contour_filter=True")
        if cal.laserscan:
            raise _not_ported("a laserscan calibration")
        self.engine = engine
        self.mode = mode
        self.device = engine.device
        # A quarter-resolution head and the native grid compose: the
        # cell-centre warp samples the head's small label map directly
        # (grid.py ``label_scale``); other modes take the lifted map.
        self.builder = OccupancyGridBuilder(
            cal, grid_cfg, mode=mode, interpolation=interpolation,
            label_scale=(engine.label_scale if interpolation == "native"
                         else 1),
            device=self.device)
        self.default_depth = 2

    # -- the device program --------------------------------------------------

    def _to_device(self, frames) -> torch.Tensor:
        return frames_to_device(frames, self.device)

    @torch.no_grad()
    def run_chunk(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K ≤ 4, H, W, 3) uint8 frames → ((K, gh, gw) int8 grids,
        (K, h, w) uint8 segmentation maps), on the device."""
        frames = self._to_device(frames)
        if frames.shape[0] > CHUNK:
            raise ValueError(f"a chunk holds at most {CHUNK} frames, got "
                             f"{frames.shape[0]}")
        heads = self.engine.segment_head(frames, self.mode)
        segs = self.engine.to_input_res(heads)
        src = heads if self.builder.label_scale > 1 else segs
        return self.builder.build(src), segs

    @torch.no_grad()
    def run_batch(self, frames) -> torch.Tensor:
        """(K, H, W, 3) uint8 frames → (K, gh, gw) int8 grids, the backbone
        batched in chunks of at most 4 frames."""
        frames = self._to_device(frames)
        return torch.cat([self.run_chunk(frames[i:i + CHUNK])[0]
                          for i in range(0, frames.shape[0], CHUNK)])

    def __call__(self, frame_bgr) -> torch.Tensor:
        """One uint8 BGR frame (H, W, 3) → int8 occupancy grid (device)."""
        grid, _ = self.segment_and_grid(frame_bgr)
        return grid

    def segment_and_grid(self, frame_bgr) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(grid, segmentation map) of one frame, on the device."""
        grids, segs = self.run_chunk(self._to_device(frame_bgr)[None])
        return grids[0], segs[0]

    # -- streaming ------------------------------------------------------------

    def stream(self,
               frames: Iterable[np.ndarray],
               depth: Optional[int] = None,
               sync_chunk: Optional[int] = None,
               ) -> Iterator[np.ndarray]:
        """Pipelined streaming: keeps up to ``depth`` frames in flight and
        yields host int8 grids in order, ``sync_chunk`` grids per
        device→host copy (default ``min(depth, 8)``)."""
        depth = self.default_depth if depth is None else depth
        if depth < 1:
            raise ValueError("depth must be >= 1")
        sync_chunk = min(depth, 8) if sync_chunk is None else sync_chunk
        inflight: List[torch.Tensor] = []

        def drain(k: int):
            chunk, inflight[:] = inflight[:k], inflight[k:]
            yield from torch.stack(chunk).cpu().numpy()

        for frame in frames:
            inflight.append(self(frame))
            if len(inflight) >= depth + sync_chunk:
                yield from drain(sync_chunk)
        while inflight:
            yield from drain(min(sync_chunk, len(inflight)))

    def warmup(self, frame_shape: Tuple[int, int, int]) -> float:
        """Run one dummy frame end to end; returns its seconds."""
        t0 = time.perf_counter()
        self(np.zeros(frame_shape, np.uint8)).cpu()
        return time.perf_counter() - t0


__all__ = ["Pipeline", "CHUNK"]
