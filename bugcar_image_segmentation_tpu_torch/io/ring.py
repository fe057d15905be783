"""ctypes wrapper for the native C++ frame ring (``io/native/frame_ring.cpp``).

Port of ``bugcar_image_segmentation_tpu/io/ring.py``, the same API:
capture threads ``push`` without blocking (the oldest frame is
overwritten), the device feed ``pop_latest`` (freshest frame and the
frames dropped past it) or ``pop_next`` (in order, for offline video).
``native/frame_ring.cpp`` is the port's own, byte-identical copy of the
JAX package's source.

The library is built at first use with ``g++ -O2 -std=c++17 -shared -fPIC
-pthread`` into ``build/native/`` beside the package, under a name that
carries a hash of the source and the flags, written under a temporary name
and renamed into place (as ``ops/cuda/build.py`` builds the kernels);
nothing is written beside the source.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent / "native" / "frame_ring.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O2", "-std=c++17", "-shared", "-fPIC", "-pthread")
_BUILD_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def library_path() -> Path:
    """Where the library for this source and these flags lives."""
    digest = hashlib.sha256(" ".join(FLAGS).encode())
    digest.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libframe_ring-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the ring unless a library for its source exists; its
    path."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    try:
        proc = subprocess.run(["g++", *FLAGS, str(SOURCE), "-o", str(tmp)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed building {SOURCE.name} (exit "
                               f"{proc.returncode}):\n{proc.stderr[-4000:]}")
        os.replace(tmp, out)
    finally:
        tmp.unlink(missing_ok=True)
    return out


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _BUILD_LOCK:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.frame_ring_create.restype = ctypes.c_void_p
        lib.frame_ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t]
        lib.frame_ring_destroy.argtypes = [ctypes.c_void_p]
        lib.frame_ring_push.restype = ctypes.c_int64
        lib.frame_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        for name in ("frame_ring_pop_latest", "frame_ring_pop_next"):
            fn = getattr(lib, name)
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
        lib.frame_ring_pending.restype = ctypes.c_int64
        lib.frame_ring_pending.argtypes = [ctypes.c_void_p]
        lib.frame_ring_close.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class FrameRing:
    """A fixed-capacity ring of (H, W, C) uint8 frames, thread-safe, with
    no allocation on the frame path."""

    def __init__(self, frame_shape: Tuple[int, ...], capacity: int = 8):
        self.frame_shape = tuple(int(v) for v in frame_shape)
        self.frame_bytes = int(np.prod(self.frame_shape))
        self._lib = _load_library()
        self._handle = self._lib.frame_ring_create(
            ctypes.c_size_t(capacity), ctypes.c_size_t(self.frame_bytes))
        if not self._handle:
            raise MemoryError("frame_ring_create failed")

    def push(self, frame: np.ndarray) -> int:
        """Copy a frame in; never blocks (the oldest frame is
        overwritten).  Returns its sequence number."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        if frame.shape != self.frame_shape:
            raise ValueError(f"frame shape {frame.shape} != ring shape "
                             f"{self.frame_shape}")
        return self._lib.frame_ring_push(
            self._handle, frame.ctypes.data_as(ctypes.c_char_p))

    def _pop(self, fn, timeout_ms: int) -> Optional[Tuple[np.ndarray, int]]:
        out = np.empty(self.frame_shape, np.uint8)
        rc = fn(self._handle, out.ctypes.data_as(ctypes.c_char_p),
                ctypes.c_int(timeout_ms))
        return None if rc < 0 else (out, int(rc))

    def pop_latest(self, timeout_ms: int = 100
                   ) -> Optional[Tuple[np.ndarray, int]]:
        """(newest frame copy, frames dropped past it) or None on timeout
        or once the ring is closed and empty."""
        return self._pop(self._lib.frame_ring_pop_latest, timeout_ms)

    def pop_next(self, timeout_ms: int = 100
                 ) -> Optional[Tuple[np.ndarray, int]]:
        """(next in-order frame copy, its sequence number) or None."""
        return self._pop(self._lib.frame_ring_pop_next, timeout_ms)

    @property
    def pending(self) -> int:
        return int(self._lib.frame_ring_pending(self._handle))

    def close(self) -> None:
        if self._handle:
            self._lib.frame_ring_close(self._handle)

    def __del__(self):
        handle, self._handle = getattr(self, "_handle", None), None
        if handle:
            self._lib.frame_ring_destroy(handle)


__all__ = ["FrameRing", "build", "library_path", "SOURCE", "BUILD_DIR"]
