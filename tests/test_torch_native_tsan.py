"""ThreadSanitizer stress test of the port's native frame ring.

Builds the port's ``io/native/frame_ring.cpp`` with the harness
``io/native/frame_ring_test.cpp`` (the JAX package's, copied byte for
byte) under ``-fsanitize=thread`` and runs it: two producers race two
consumers for 4000 frames; TSan must find no data race and every popped
frame must be untorn, as tests/test_native_tsan.py holds the JAX
package's ring.
"""

import os
import shutil
import subprocess

import pytest

NATIVE = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "bugcar_image_segmentation_tpu_torch", "io",
    "native")


@pytest.mark.skipif(shutil.which("g++") is None, reason="no g++")
def test_frame_ring_tsan(tmp_path):
    binary = str(tmp_path / "frame_ring_tsan")
    build = subprocess.run(
        ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=thread", "-pthread",
         os.path.join(NATIVE, "frame_ring.cpp"),
         os.path.join(NATIVE, "frame_ring_test.cpp"),
         "-o", binary],
        capture_output=True, text=True, timeout=120)
    assert build.returncode == 0, build.stderr
    run = subprocess.run([binary], capture_output=True, text=True,
                         timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "OK: no torn frames" in run.stdout
    assert "WARNING: ThreadSanitizer" not in run.stderr


def test_harness_is_the_jax_packages():
    """The harness is the JAX package's file, byte for byte."""
    jax_native = NATIVE.replace("bugcar_image_segmentation_tpu_torch",
                                "bugcar_image_segmentation_tpu")
    with open(os.path.join(NATIVE, "frame_ring_test.cpp"), "rb") as a, \
            open(os.path.join(jax_native, "frame_ring_test.cpp"), "rb") as b:
        assert a.read() == b.read()
