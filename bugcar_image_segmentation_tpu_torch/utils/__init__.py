"""Host-side utilities: the Flax checkpoint reader and writer and
train-state checkpoints (:mod:`~.checkpoint`), the span and counter
recorder, the FPS meter and the profiler trace (:mod:`~.profiling`), the
logger and the camera probe.

The JAX package's ``utils/cache.py`` (XLA's persistent compile cache) has
no counterpart here: the port's compiled artifacts are the hash-named
libraries of ``ops/cuda/build.py`` (the kernels) and ``io/ring.py`` (the
frame ring), built once under ``build/`` and reused while their sources
are unchanged.
"""

from __future__ import annotations

import logging
from typing import List

from .profiling import FPSMeter, trace


def get_logger(name: str = "bugcar_torch") -> logging.Logger:
    """A logger with one timestamped stream handler, INFO level."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler()
        handler.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
    return logger


def probe_cameras(max_index: int = 10) -> List[int]:
    """Indices of openable video devices (the reference's ``testDevice``,
    returning the result); imports cv2, which the GPU host lacks."""
    import cv2

    available = []
    for i in range(max_index):
        cap = cv2.VideoCapture(i)
        if cap is not None and cap.isOpened():
            available.append(i)
            cap.release()
    return available


__all__ = ["FPSMeter", "trace", "get_logger", "probe_cameras"]
