"""The camera→occupancy-grid pipeline on the device.

Port of ``bugcar_image_segmentation_tpu/pipeline.py`` (``Pipeline``; the
reference's ``inference_video.py`` hot loop, SURVEY.md §3.1):

    uint8 BGR frame → resize/normalize → backbone → argmax → 3-class remap
    → BEV warp → morph-open → cell binning → int8 grid

all on the engine's device; a raw frame goes in and an int8 grid comes
out.  Options, as in the JAX package: CLAHE on the camera frame before the
backbone (``use_clahe``), the footwell-connectivity road filter on the
label map (``contour_filter``; ``postproc.py``), and laserscan
calibrations (the grid ray-cast through polar plans; binary mode returns
the (plain, ray-cast) pair stacked as a (2, H, W) grid).  Batches run
through the backbone in chunks of at most 4 frames.
``stream()`` keeps ``depth`` frames in flight: CUDA launches are
asynchronous, so the host prepares frame N+1 while the device computes
frame N, and results are fetched ``sync_chunk`` grids per device→host
copy; ``transfer_batch=K`` ships K frames per host→device copy.

Two transports, as in the JAX package:

- ``"bgr"``: the camera frame goes to the device as it is and is resized
  there — or, with ``host_resize=True``, resized on the host first
  (``ops/host_resize.py``, cv2's INTER_LINEAR bytes without cv2);
- ``"i420"`` (needs ``host_resize=True``): the host resizes and packs the
  frame as YUV 4:2:0, half the bytes of BGR (``ops/yuv.py``), and the
  device converts it back to BGR, frame by frame, inside the program.
  This is the path ``bench.py`` measures.

:class:`MultiCameraPipeline` (BASELINE config 4) runs N cameras through
the backbone as one batch, builds one grid per camera, each with its own
calibration into the shared vehicle grid, and merges them by elementwise
max (:func:`stitch_grids`).

While recording is on (``utils/profiling.py``), a frame records the spans
``pipeline.frame`` → ``pipeline.upload`` and ``pipeline.program`` (→ the
engine's and the grid builder's spans), a stream ``pipeline.dispatch`` and
``pipeline.drain``, with the counter ``grids_out`` (the grids a drain
delivers) and, on the card, the ``device_backlog`` gauge: at each
dispatch, the earlier dispatches the card has not finished.
"""

from __future__ import annotations

import time
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from . import postproc
from .configs import CalibrationConfig, GridConfig, RuntimeConfig
from .grid import OccupancyGridBuilder
from .models import remap
from .models.api import Engine, frames_to_device
from .ops import yuv
from .ops.host_resize import resize_linear
from .utils.profiling import active, count, gauge, span

CHUNK = 4   # most frames one backbone batch runs


class Pipeline:
    """Single-camera frame→grid pipeline.

    Args:
      engine: an :class:`~.models.api.Engine`.
      cal: calibration whose ``input_shape`` (w, h) matches the engine's
        output resolution.
      grid_cfg: metric grid geometry.
      mode: "multiclass" or "binary" (reference bev.py:166 / 97).
      interpolation: warp parity mode (see grid.py).
      use_clahe: CLAHE (``postproc.clahe``) on each frame on the device,
        before the backbone.
      contour_filter: demote road regions not connected to the bottom
        strip (``postproc.contour_noise_removal``) to flat-non-road
        (multiclass) or drop them (binary), at input resolution.
      host_resize: resize camera frames to the model's resolution on the
        host, before the host→device copy.
      transport: "bgr" or "i420" (see the module docstring).
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
        if transport == "i420" and not host_resize:
            # The planes are packed at model resolution on the host.
            raise ValueError("transport='i420' requires host_resize=True")
        self.engine = engine
        self.use_clahe = use_clahe
        self.contour_filter = contour_filter
        self.mode = mode
        self.device = engine.device
        self.transport = transport
        self.host_resize = host_resize
        self._model_hw = got
        # A quarter-resolution head and the native grid compose: the
        # cell-centre warp samples the head's small label map directly
        # (grid.py ``label_scale``); other modes, and the contour filter,
        # which runs at input resolution, take the lifted map.
        self.builder = OccupancyGridBuilder(
            cal, grid_cfg, mode=mode, interpolation=interpolation,
            label_scale=(engine.label_scale
                         if interpolation == "native" and not contour_filter
                         else 1),
            device=self.device)
        self.default_depth = 2

    @classmethod
    def from_configs(cls,
                     engine: Engine,
                     cal: CalibrationConfig,
                     grid_cfg: GridConfig,
                     runtime: RuntimeConfig,
                     **overrides) -> "Pipeline":
        """A pipeline from a :class:`~.configs.RuntimeConfig`: its
        ``warp_interpolation`` selects the warp mode and its
        ``pipeline_depth`` becomes the default streaming depth; keyword
        overrides win."""
        kwargs = dict(interpolation=runtime.warp_interpolation)
        kwargs.update(overrides)
        pipe = cls(engine, cal, grid_cfg, **kwargs)
        pipe.default_depth = runtime.pipeline_depth
        return pipe

    # -- host side -----------------------------------------------------------

    def _prep_host(self, frame_bgr) -> np.ndarray:
        """One camera frame → what crosses to the device: resized to the
        model's resolution (``host_resize``), then packed as I420
        (``transport="i420"``)."""
        if isinstance(frame_bgr, torch.Tensor):
            frame_bgr = frame_bgr.cpu().numpy()
        frame = np.asarray(frame_bgr)
        if self.host_resize and frame.shape[:2] != self._model_hw:
            frame = resize_linear(frame, self._model_hw)
        if self.transport == "i420":
            frame = yuv.bgr_to_i420_host(frame)
        return frame

    def _upload(self, frames) -> torch.Tensor:
        """Camera frames ((K, H, W, 3), or a list of K) → the device
        program's input, in one host→device copy."""
        with span("pipeline.upload"):
            if self.host_resize:
                frames = np.stack([self._prep_host(f) for f in frames])
            elif isinstance(frames, list):
                frames = np.stack(frames)
            return frames_to_device(frames, self.device)

    # -- the device program --------------------------------------------------

    @torch.no_grad()
    def _program(self, frames: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Uploaded frames (K ≤ 4) → ((K, gh, gw) int8 grids, or (K, 2,
        gh, gw) in binary laserscan mode; (K, h, w) uint8 segmentation
        maps), on the device."""
        if frames.shape[0] > CHUNK:
            raise ValueError(f"a chunk holds at most {CHUNK} frames, got "
                             f"{frames.shape[0]}")
        with span("pipeline.program"):
            if self.transport == "i420":
                # frame by frame, as the JAX program converts a chunk
                frames = torch.stack([yuv.i420_to_bgr(f, self._model_hw)
                                      for f in frames])
            if self.use_clahe:
                frames = postproc.clahe(frames)
            heads = self.engine.segment_head(frames, self.mode)
            segs = self.engine.to_input_res(heads)
            if self.contour_filter:
                road = (segs == remap.ROAD).to(torch.uint8)
                kept = postproc.contour_noise_removal(road)
                if self.mode == "multiclass":
                    segs = torch.where(
                        (road == 1) & (kept == 0),
                        torch.full_like(segs, remap.FLAT_NON_ROAD), segs)
                else:
                    segs = kept
            src = heads if self.builder.label_scale > 1 else segs
            grids = self.builder.build(src)
            if isinstance(grids, tuple):
                # binary + laserscan: (plain, ray-cast), stacked so that
                # batches and streams carry one tensor (grid[..., 0, :, :]
                # plain, grid[..., 1, :, :] ray-cast)
                grids = torch.stack(grids, dim=-3)
            return grids, segs

    def _program_batch(self, frames: torch.Tensor) -> torch.Tensor:
        """Uploaded frames → grids, the backbone in chunks of ≤ 4."""
        return torch.cat([self._program(frames[i:i + CHUNK])[0]
                          for i in range(0, frames.shape[0], CHUNK)])

    def run_chunk(self, frames) -> Tuple[torch.Tensor, torch.Tensor]:
        """(K ≤ 4, H, W, 3) uint8 camera frames → ((K, gh, gw) int8 grids,
        (K, h, w) uint8 segmentation maps), on the device."""
        if len(frames) > CHUNK:
            raise ValueError(f"a chunk holds at most {CHUNK} frames, got "
                             f"{len(frames)}")
        return self._program(self._upload(frames))

    def run_batch(self, frames) -> torch.Tensor:
        """(K, H, W, 3) uint8 camera frames → (K, gh, gw) int8 grids: one
        host→device copy, the backbone in chunks of at most 4 frames."""
        return self._program_batch(self._upload(frames))

    def __call__(self, frame_bgr) -> torch.Tensor:
        """One uint8 BGR frame (H, W, 3) → int8 occupancy grid (device)."""
        grid, _ = self.segment_and_grid(frame_bgr)
        return grid

    def segment_and_grid(self, frame_bgr) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """(grid, segmentation map) of one frame, on the device."""
        with span("pipeline.frame"):
            grids, segs = self._program(self._upload(frame_bgr[None]))
            return grids[0], segs[0]

    # -- streaming ------------------------------------------------------------

    def stream(self,
               frames: Iterable[np.ndarray],
               depth: Optional[int] = None,
               sync_chunk: Optional[int] = None,
               transfer_batch: int = 1,
               ) -> Iterator[np.ndarray]:
        """Pipelined streaming: keeps up to ``depth`` dispatches in flight
        and yields host int8 grids in order.

        - ``sync_chunk``: dispatches fetched per device→host copy (default
          ``min(depth, 8)``).
        - ``transfer_batch``: K frames go to the device as ONE host→device
          copy and through the backbone together (in chunks of ≤ 4); a
          final partial batch is padded with its last frame and the
          padding dropped at the drain.  It adds up to K-1 frames of
          latency: for recorded video, not a live camera.
        """
        depth = self.default_depth if depth is None else depth
        if depth < 1:
            raise ValueError("depth must be >= 1")
        if transfer_batch < 1:
            raise ValueError("transfer_batch must be >= 1")
        sync_chunk = min(depth, 8) if sync_chunk is None else sync_chunk
        # (K grids, valid, event): the event is recorded on the card after
        # the dispatch's work while recording is on, else None
        inflight: list = []
        pending: list = []
        card = self.device.type == "cuda"

        def backlog() -> Optional[int]:
            """Earlier dispatches the card has not finished (they finish
            in order); None while one of them carries no event."""
            n = 0
            for _, _, event in reversed(inflight):
                if event is None:
                    return None
                if event.query():
                    break
                n += 1
            return n

        def dispatch():
            if not pending:
                return
            with span("pipeline.dispatch"):
                event = None
                if card and active():
                    queued = backlog()
                    if queued is not None:
                        gauge("device_backlog", queued)
                    event = torch.cuda.Event()
                n = len(pending)
                if transfer_batch == 1:
                    grids = self(pending[0])[None]
                else:
                    padded = pending + [pending[-1]] * (transfer_batch - n)
                    grids = self._program_batch(self._upload(padded))
                if event is not None:
                    event.record()
                inflight.append((grids, n, event))
            pending.clear()

        def drain(k: int):
            chunk, inflight[:] = inflight[:k], inflight[k:]
            with span("pipeline.drain"):
                fetched = torch.cat([g for g, _, _ in chunk]).cpu().numpy()
                count("grids_out", sum(n for _, n, _ in chunk))
            off = 0
            for g, n, _ in chunk:
                yield from fetched[off:off + n]
                off += g.shape[0]

        for frame in frames:
            pending.append(frame)
            if len(pending) >= transfer_batch:
                dispatch()
            if len(inflight) >= depth + sync_chunk:
                yield from drain(sync_chunk)
        dispatch()
        while inflight:
            yield from drain(min(sync_chunk, len(inflight)))

    def warmup(self, frame_shape: Tuple[int, int, int]) -> float:
        """Run one dummy camera frame of ``frame_shape`` (H, W, 3) end to
        end; returns its seconds."""
        t0 = time.perf_counter()
        self(np.zeros(frame_shape, np.uint8)).cpu()
        return time.perf_counter() - t0


class MultiCameraPipeline:
    """N cameras → one stitched vehicle grid (BASELINE config 4).

    Each camera has its own calibration (its own homography into the
    shared vehicle grid); the frames run through the backbone as one batch
    (frame by frame where :attr:`Engine.frame_by_frame` says so), one
    multiclass grid is built per camera, and the grids merge by elementwise
    max (:func:`stitch_grids`).  A quarter-resolution head with the native
    grid reads the small label maps, as :class:`Pipeline` does.
    """

    def __init__(self,
                 engine: Engine,
                 cals: Sequence[CalibrationConfig],
                 grid_cfg: GridConfig,
                 interpolation: str = "cv2_linear"):
        if not cals:
            raise ValueError("need at least one calibration")
        self.engine = engine
        scale = engine.label_scale if interpolation == "native" else 1
        self.builders = [OccupancyGridBuilder(c, grid_cfg,
                                              interpolation=interpolation,
                                              label_scale=scale,
                                              device=engine.device)
                         for c in cals]
        if len({(b.geom.cells_h, b.geom.cells_w)
                for b in self.builders}) != 1:
            raise ValueError("all cameras must share the grid geometry")

    @torch.no_grad()
    def __call__(self, frames_bgr) -> torch.Tensor:
        """(N_cam, H, W, 3) uint8 BGR → stitched int8 grid, on the
        engine's device."""
        frames = frames_to_device(frames_bgr, self.engine.device)
        if frames.dim() != 4 or frames.shape[0] != len(self.builders):
            raise ValueError(f"want ({len(self.builders)}, H, W, 3) frames, "
                             f"one per camera; got {tuple(frames.shape)}")
        segs = self.engine.segment_head(frames)
        if self.builders[0].label_scale == 1:
            segs = self.engine.to_input_res(segs)
        return stitch_grids(torch.stack([b.build(segs[k]) for k, b in
                                         enumerate(self.builders)]))


def stitch_grids(grids: torch.Tensor) -> torch.Tensor:
    """Merge per-camera int8 grids (N, H, W): occupied (100) > free (0) >
    unknown (-1), which elementwise max implements."""
    return grids.amax(0)


def segment_frame(frame_bgr,
                  engine: Engine,
                  cal: CalibrationConfig,
                  grid_cfg: GridConfig,
                  mode: str = "multiclass") -> torch.Tensor:
    """One-shot functional wrapper: a frame's grid through a fresh
    :class:`Pipeline` (it plans the warp at every call and caches
    nothing)."""
    return Pipeline(engine, cal, grid_cfg, mode=mode)(frame_bgr)


__all__ = ["Pipeline", "MultiCameraPipeline", "stitch_grids", "CHUNK",
           "segment_frame"]
