"""The port's host-side resize (``ops/host_resize.py``, numpy) against
``cv2.resize(..., interpolation=cv2.INTER_LINEAR)``: byte for byte, at
the bench path's sizes, an upscale, odd sizes, and — with hypothesis —
over small shapes and channel counts."""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from bugcar_image_segmentation_tpu_torch import synthetic
from bugcar_image_segmentation_tpu_torch.ops.host_resize import resize_linear

cv2 = pytest.importorskip("cv2")

CASES = [((480, 640), (256, 512)),     # the camera frame → ENet (bench.py)
         ((720, 1280), (256, 512)),
         ((120, 160), (256, 512)),     # upscale
         ((256, 512), (480, 640)),
         ((37, 53), (19, 29)),         # odd sizes
         ((13, 7), (31, 45)),
         ((120, 160), (64, 128)),      # the bench-path test's frames
         ((5, 5), (3, 3))]


def _want(frame, hw):
    return cv2.resize(frame, (hw[1], hw[0]), interpolation=cv2.INTER_LINEAR)


@pytest.mark.parametrize("src,dst", CASES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}" for a, b in CASES])
def test_equals_cv2(src, dst):
    rng = np.random.default_rng(src[0] * 31 + dst[1])
    for frame in (rng.integers(0, 256, src + (3,), np.uint8),
                  rng.integers(0, 256, src, np.uint8),
                  np.full(src + (3,), 255, np.uint8)):
        got = resize_linear(frame, dst)
        assert got.dtype == np.uint8 and got.shape == dst + frame.shape[2:]
        np.testing.assert_array_equal(got, _want(frame, dst))


def test_equals_cv2_on_road_frames():
    for f, _, _ in synthetic.video(seed=2, num_frames=3, shape=(480, 640)):
        np.testing.assert_array_equal(resize_linear(f, (256, 512)),
                                      _want(f, (256, 512)))


def test_rejects_non_uint8():
    with pytest.raises(ValueError, match="uint8"):
        resize_linear(np.zeros((4, 4, 3), np.float32), (2, 2))
    with pytest.raises(ValueError, match="positive"):
        resize_linear(np.zeros((4, 4, 3), np.uint8), (0, 2))


@settings(max_examples=60, deadline=None)
@given(sh=st.integers(1, 40), sw=st.integers(1, 40), dh=st.integers(1, 40),
       dw=st.integers(1, 40), channels=st.sampled_from([1, 3, 4]),
       seed=st.integers(0, 2 ** 16))
def test_equals_cv2_on_small_shapes(sh, sw, dh, dw, channels, seed):
    frame = np.random.default_rng(seed).integers(0, 256, (sh, sw, channels),
                                                 np.uint8)
    want = _want(frame, (dh, dw)).reshape(dh, dw, channels)
    np.testing.assert_array_equal(resize_linear(frame, (dh, dw)), want)
