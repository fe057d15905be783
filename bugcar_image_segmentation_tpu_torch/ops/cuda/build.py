"""Build the port's CUDA kernels with plain nvcc and load them with ctypes.

Every ``csrc/*.cu`` source is compiled by one ``nvcc`` call into one
shared library with a C interface (no PyTorch headers, so the build takes
seconds), at first use, into ``build/kernels/`` beside the package.  The
library's name carries a hash of the sources and flags: an unchanged tree
loads the existing library, a changed one rebuilds.  The library is
written under a temporary name and renamed into place, so an interrupted
build leaves nothing that a later one would wait on.

Nothing here runs at import time: the CPU tests import every module, and
the CPU host has no nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

PACKAGE_DIR = Path(__file__).resolve().parents[2]
SOURCE_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
NVCC_TIMEOUT_S = 600

# Filled by the first library() call: seconds nvcc took (0.0 when an
# existing library was loaded) and its output (ptxas register / shared
# memory / spill report).
build_seconds: Optional[float] = None
build_log: str = ""

_lib: Optional[ctypes.CDLL] = None

_P, _I = ctypes.c_void_p, ctypes.c_int


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for root in filter(None, (home, "/usr/local/cuda")):
        cand = Path(root) / "bin" / "nvcc"
        if cand.exists():
            return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels are built on the GPU host")


def _library_path() -> Path:
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources in {SOURCE_DIR}")
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libbugcar_kernels-{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them exists; its path."""
    global build_seconds, build_log
    out = _library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = [str(s) for s in sorted(SOURCE_DIR.glob("*.cu"))]
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True,
                          timeout=NVCC_TIMEOUT_S)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed (exit {proc.returncode}):\n"
                           f"{' '.join(cmd)}\n{proc.stderr[-6000:]}")
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    build_log = proc.stdout + proc.stderr
    out.with_suffix(".log").write_text(build_log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.bugcar_fused_bottleneck.argtypes = (
            [_P, _P] + [_I] * 5 + [_P] * 12 + [_I, _I, _I, _P])
        lib.bugcar_fused_bottleneck.restype = _I
        lib.bugcar_fused_bottleneck_smem_bytes.argtypes = [_I, _I]
        lib.bugcar_fused_bottleneck_smem_bytes.restype = _I
        lib.bugcar_cuda_error_string.argtypes = [_I]
        lib.bugcar_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error."""
    if err != 0:
        msg = library().bugcar_cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


__all__ = ["build", "library", "check", "BUILD_DIR", "SOURCE_DIR"]
