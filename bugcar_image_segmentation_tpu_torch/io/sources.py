"""Frame sources: cameras, video files, synthetic streams, capture threads.

Port of ``bugcar_image_segmentation_tpu/io/sources.py``: sources that share
one iterator protocol, with bounded retries and a clean stop where the
reference's loop died with its camera.  :class:`ThreadedCapture` runs any
source on a capture thread feeding the native :class:`~.ring.FrameRing`,
so camera IO overlaps the device's work and slow frames are dropped rather
than queued (live cameras) or held back (offline sources).

cv2 is imported inside :class:`OpenCVSource` only: the GPU host has none,
and the synthetic source needs none.
"""

from __future__ import annotations

import threading
import time
from typing import Iterator, Optional, Tuple

import numpy as np

from .ring import FrameRing


class SyntheticSource:
    """Deterministic moving-gradient frames, for benchmarks and tests
    (the JAX package's bytes)."""

    def __init__(self, shape: Tuple[int, int, int] = (480, 640, 3),
                 num_frames: Optional[int] = None, seed: int = 0):
        self.shape = shape
        self.num_frames = num_frames
        h, w, _ = shape
        yy, xx = np.mgrid[0:h, 0:w]
        self._base = ((yy * 255 // max(h - 1, 1))[..., None]
                      + (xx * 255 // max(w - 1, 1))[..., None]
                      * np.array([0, 1, 2])).astype(np.int32)
        self._i = 0

    def read(self) -> Optional[np.ndarray]:
        if self.num_frames is not None and self._i >= self.num_frames:
            return None
        frame = ((self._base + self._i * 7) % 256).astype(np.uint8)
        self._i += 1
        return frame

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame


class OpenCVSource:
    """``cv2.VideoCapture`` (device index or video path) with a bounded
    retry on read failure."""

    def __init__(self, source, max_failures: int = 30):
        import cv2

        self._cap = cv2.VideoCapture(source)
        if not self._cap.isOpened():
            raise IOError(f"cannot open video source {source!r}")
        self.max_failures = max_failures

    def read(self) -> Optional[np.ndarray]:
        failures = 0
        while failures < self.max_failures:
            ok, frame = self._cap.read()
            if ok and frame is not None:
                return frame
            failures += 1
            time.sleep(0.005)
        return None

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            frame = self.read()
            if frame is None:
                return
            yield frame

    def release(self) -> None:
        self._cap.release()


class ThreadedCapture:
    """Capture thread → native FrameRing → consumer.

    The thread pushes every frame the source yields; the consumer takes the
    freshest frame (:meth:`latest`, live cameras: older frames count as
    dropped) or the next in order (:meth:`next`, recorded video).  With
    ``block_when_full`` the thread waits while the ring is one short of
    full, so an offline source loses no frame to backpressure.
    """

    def __init__(self, source, frame_shape: Tuple[int, int, int],
                 capacity: int = 8, block_when_full: bool = False):
        self.source = source
        self.ring = FrameRing(frame_shape, capacity=capacity)
        self._capacity = capacity
        self.block_when_full = block_when_full
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.frames_pushed = 0

    def start(self) -> "ThreadedCapture":
        def run():
            for frame in self.source:
                if self._stop.is_set():
                    break
                if self.block_when_full:
                    while (self.ring.pending >= self._capacity - 1
                           and not self._stop.is_set()):
                        time.sleep(0.001)
                self.ring.push(frame)
                self.frames_pushed += 1
            self.ring.close()

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def latest(self, timeout_ms: int = 200
               ) -> Optional[Tuple[np.ndarray, int]]:
        """(freshest frame, frames dropped past it) or None when the
        source is exhausted."""
        return self.ring.pop_latest(timeout_ms)

    def next(self, timeout_ms: int = 200
             ) -> Optional[Tuple[np.ndarray, int]]:
        """(next in-order frame, its sequence number) or None when the
        source is exhausted.  Without ``block_when_full`` a producer that
        outruns the consumer by more than the ring's capacity still
        overwrites."""
        return self.ring.pop_next(timeout_ms)

    def stop(self) -> None:
        self._stop.set()
        self.ring.close()
        if self._thread is not None:
            self._thread.join(timeout=2.0)


__all__ = ["SyntheticSource", "OpenCVSource", "ThreadedCapture"]
