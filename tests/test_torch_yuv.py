"""The port's I420 transport (``ops/yuv.py``) against cv2 and the JAX
package.

- ``bgr_to_i420_host`` (numpy) must give ``cv2.cvtColor(frame,
  COLOR_BGR2YUV_I420)`` byte for byte.
- ``i420_to_bgr`` (torch) must give the JAX package's ``ops/yuv.
  i420_to_bgr``: op by op (JAX eager) byte for byte; against the jitted
  function — the form the JAX ``Pipeline`` runs — XLA's CPU code for the
  fused conversion rounds a few ``.5`` ties of the f32 expression the
  other way.  Measured on the inputs of ``test_i420_to_bgr_equals_jax``
  (all three sizes): 152 of 2,852,352 values differ (5.3e-5), each by 1.
  Pinned: at most 2e-4 of the values differ, none by more than 1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.ops import yuv as jyuv
from bugcar_image_segmentation_tpu_torch import synthetic
from bugcar_image_segmentation_tpu_torch.ops import yuv

cv2 = pytest.importorskip("cv2")

SHAPES = [(480, 640), (256, 512), (64, 128), (120, 160), (6, 10), (2, 2)]
JIT_SHARE = 2e-4      # pinned: share of values that may differ from jit


def _frames(hw, seed):
    rng = np.random.default_rng(seed)
    flat = np.tile(rng.integers(0, 256, (1, 1, 3), np.uint8), hw + (1,))
    extremes = np.where(rng.random(hw + (1,)) < 0.5, 0, 255).astype(
        np.uint8) * np.ones(3, np.uint8)
    return [rng.integers(0, 256, hw + (3,), np.uint8), flat, extremes]


@pytest.mark.parametrize("hw", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
def test_bgr_to_i420_host_equals_cv2(hw):
    for f in _frames(hw, sum(hw)):
        got = yuv.bgr_to_i420_host(f)
        assert got.shape == yuv.i420_shape(hw) and got.dtype == np.uint8
        np.testing.assert_array_equal(
            got, cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420))


def test_bgr_to_i420_host_equals_cv2_on_road_frames():
    for f, _, _ in synthetic.video(seed=3, num_frames=3, shape=(480, 640)):
        np.testing.assert_array_equal(
            yuv.bgr_to_i420_host(f), cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420))


def test_i420_shape_and_input_checks():
    assert yuv.i420_shape((256, 512)) == (384, 512)
    with pytest.raises(ValueError, match="even"):
        yuv.i420_shape((255, 512))
    with pytest.raises(ValueError, match="uint8"):
        yuv.bgr_to_i420_host(np.zeros((4, 4, 3), np.float32))


def _packed(hw, seed):
    """cv2-packed frames and random buffers (every byte pattern)."""
    rng = np.random.default_rng(seed)
    real = [cv2.cvtColor(f, cv2.COLOR_BGR2YUV_I420)
            for f in _frames(hw, seed)]
    return real + [rng.integers(0, 256, yuv.i420_shape(hw), np.uint8)
                   for _ in range(3)]


@pytest.mark.parametrize("hw", [(64, 128), (256, 512), (120, 160)],
                         ids=["64x128", "256x512", "120x160"])
def test_i420_to_bgr_equals_jax(hw):
    jitted = jax.jit(lambda b: jyuv.i420_to_bgr(b, hw))
    differ = total = 0
    for buf in _packed(hw, 7):
        got = yuv.i420_to_bgr(torch.as_tensor(buf), hw).numpy()
        assert got.shape == hw + (3,) and got.dtype == np.uint8
        # op by op: bit for bit
        np.testing.assert_array_equal(
            got, np.asarray(jyuv.i420_to_bgr(jnp.asarray(buf), hw)))
        want = np.asarray(jitted(buf)).astype(np.int16)
        d = np.abs(got.astype(np.int16) - want)
        assert d.max() <= 1
        differ += int((d > 0).sum())
        total += d.size
    assert differ / total <= JIT_SHARE, (differ, total)


def test_i420_to_bgr_batched_equals_single():
    hw = (64, 128)
    bufs = np.stack(_packed(hw, 11))
    batched = yuv.i420_to_bgr(torch.as_tensor(bufs), hw).numpy()
    assert batched.shape == (len(bufs),) + hw + (3,)
    for buf, got in zip(bufs, batched):
        np.testing.assert_array_equal(
            got, yuv.i420_to_bgr(torch.as_tensor(buf), hw).numpy())
    np.testing.assert_array_equal(
        batched, np.asarray(jyuv.i420_to_bgr(jnp.asarray(bufs), hw)))


def test_i420_round_trip_within_one_of_cv2():
    """The JAX package's claim for its device conversion: within ±1 of
    cv2's ``COLOR_YUV2BGR_I420``."""
    hw = (120, 160)
    for buf in _packed(hw, 5)[:3]:
        got = yuv.i420_to_bgr(torch.as_tensor(buf), hw).numpy()
        want = cv2.cvtColor(buf, cv2.COLOR_YUV2BGR_I420)
        assert np.abs(got.astype(int) - want).max() <= 1
