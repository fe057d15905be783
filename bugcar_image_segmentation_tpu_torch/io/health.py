"""Stream health: a stall watchdog and frame-drop accounting.

Port of ``bugcar_image_segmentation_tpu/io/health.py``.  The reference had
no failure handling ("a dropped camera kills the loop"); the watchdog
notices when the frame loop stops ticking (camera unplugged, source wedged,
device hang) and calls a recovery callback, and the counter aggregates the
drops the frame ring reports.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

from ..utils import get_logger

_log = get_logger("health")


class StallWatchdog:
    """Calls ``on_stall(age_seconds)`` once per stall episode when
    :meth:`tick` has not been called for ``stall_after_s``; a background
    thread checks every ``poll_s`` seconds, and the next tick re-arms it."""

    def __init__(self,
                 stall_after_s: float = 2.0,
                 on_stall: Optional[Callable[[float], None]] = None,
                 poll_s: float = 0.25):
        self.stall_after_s = stall_after_s
        self.on_stall = on_stall or (
            lambda age: _log.warning("stream stalled for %.2fs", age))
        self._poll_s = poll_s
        self._last_tick = time.monotonic()
        self._stalled = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.stall_count = 0

    def start(self) -> "StallWatchdog":
        def run():
            while not self._stop.wait(self._poll_s):
                age = time.monotonic() - self._last_tick
                if age >= self.stall_after_s:
                    if not self._stalled:
                        self._stalled = True
                        self.stall_count += 1
                        self.on_stall(age)
                else:
                    self._stalled = False

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def tick(self) -> None:
        self._last_tick = time.monotonic()
        self._stalled = False

    @property
    def stalled(self) -> bool:
        return self._stalled

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


class DropCounter:
    """Aggregates the drop counts ``FrameRing.pop_latest`` reports."""

    def __init__(self):
        self.frames = 0
        self.dropped = 0

    def record(self, dropped: int) -> None:
        self.frames += 1
        self.dropped += max(dropped, 0)

    @property
    def drop_rate(self) -> float:
        total = self.frames + self.dropped
        return self.dropped / total if total else 0.0


__all__ = ["StallWatchdog", "DropCounter"]
