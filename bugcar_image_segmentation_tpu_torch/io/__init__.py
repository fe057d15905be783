"""Frame IO: the native C++ frame ring, frame sources and capture threads,
stream health.

- :mod:`~.ring`: ctypes wrapper over ``io/native/frame_ring.cpp`` (built
  with g++ at first use into ``build/native/``);
- :mod:`~.sources`: synthetic and cv2 sources, :class:`ThreadedCapture`;
- :mod:`~.health`: :class:`StallWatchdog`, :class:`DropCounter`.
"""

from .health import DropCounter, StallWatchdog
from .ring import FrameRing
from .sources import OpenCVSource, SyntheticSource, ThreadedCapture

__all__ = ["DropCounter", "FrameRing", "OpenCVSource", "StallWatchdog",
           "SyntheticSource", "ThreadedCapture"]
