"""Build the port's CUDA kernels with plain nvcc and load them with ctypes.

Every ``csrc/*.cu`` source (with the ``csrc/*.cuh`` headers they include)
is compiled by its own ``nvcc`` process, all started together, and the objects are linked by one more ``nvcc`` call
into one shared library with a C interface (no PyTorch headers, so the
build takes seconds), at first use, into ``build/kernels/`` beside the
package.  The library's name carries a hash of the sources and flags: an
unchanged tree loads the existing library, a changed one rebuilds.  The
objects and the library are written under temporary names and the library
is renamed into place, so an interrupted build leaves nothing that a
later one would wait on.

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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
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
    for src in sources + sorted(SOURCE_DIR.glob("*.cuh")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libbugcar_kernels-{digest.hexdigest()[:16]}.so"


def _run(cmds, what: str) -> str:
    """Run the commands in parallel; their joined output, or raise with the
    first failure's."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = []
    try:
        for cmd, proc in zip(cmds, procs):
            out, _ = proc.communicate(timeout=NVCC_TIMEOUT_S)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"{what} failed (exit {proc.returncode}):\n"
                    f"{' '.join(cmd)}\n{out[-6000:]}")
            logs.append(out)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return "".join(logs)


def build() -> Path:
    """Compile the sources unless a library for them exists; its path."""
    global build_seconds, build_log
    out = _library_path()
    if out.exists():
        build_seconds = 0.0
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(SOURCE_DIR.glob("*.cu"))
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    tmp = BUILD_DIR / f"{tag}.tmp.so"
    nvcc = _nvcc()
    t0 = time.perf_counter()
    try:
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(sources, objs)], "nvcc")
        log += _run([[nvcc, "-shared", "-o", str(tmp), *map(str, objs)]],
                    "nvcc link")
        os.replace(tmp, out)
    finally:
        for f in (*objs, tmp):
            f.unlink(missing_ok=True)
    build_seconds = time.perf_counter() - t0
    build_log = log
    out.with_suffix(".log").write_text(build_log)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.bugcar_fused_bottleneck.argtypes = (
            [_P, _P] + [_I] * 5 + [_P] * 13 + [_I, _I, _I, _P])
        lib.bugcar_fused_bottleneck.restype = _I
        lib.bugcar_fused_bottleneck_plan.argtypes = (
            [_I] * 6 + [ctypes.POINTER(ctypes.c_int)])
        lib.bugcar_fused_bottleneck_plan.restype = _I
        lib.bugcar_fused_bottleneck_smem_bytes.argtypes = [_I] * 4
        lib.bugcar_fused_bottleneck_smem_bytes.restype = _I
        for name in ("bugcar_flash_attention", "bugcar_flash_attention_t"):
            fn = getattr(lib, name)
            fn.argtypes = [_P] * 4 + [_I] * 4 + [ctypes.c_float, _I, _P]
            fn.restype = _I
        lib.bugcar_flash_attention_plan.argtypes = (
            [_I] * 3 + [ctypes.POINTER(ctypes.c_int)])
        lib.bugcar_flash_attention_plan.restype = _I
        lib.bugcar_flash_attention_bf16_plan.argtypes = (
            [_P] * 4 + [_I] * 4 + [ctypes.c_float, _I, _I, _I, _P])
        lib.bugcar_flash_attention_bf16_plan.restype = _I
        lib.bugcar_fused_sepconv.argtypes = [_P] * 8 + [_I] * 11 + [_P]
        lib.bugcar_fused_sepconv.restype = _I
        lib.bugcar_fused_sepconv_max_clusters.argtypes = [_I, _I, _I]
        lib.bugcar_fused_sepconv_max_clusters.restype = _I
        lib.bugcar_strided_gather.argtypes = [_P, _P] + [_I] * 6 + [_P]
        lib.bugcar_strided_gather.restype = _I
        lib.bugcar_halo_add.argtypes = [_P, _P] + [_I] * 4 + [_P]
        lib.bugcar_halo_add.restype = _I
        lib.bugcar_strided_gather_tma.argtypes = [_P, _P] + [_I] * 6 + [
            _P, _P]
        lib.bugcar_strided_gather_tma.restype = _I
        lib.bugcar_halo_add_tma.argtypes = [_P, _P] + [_I] * 4 + [_P, _P]
        lib.bugcar_halo_add_tma.restype = _I
        lib.bugcar_empty.argtypes = [_P]
        lib.bugcar_empty.restype = _I
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
