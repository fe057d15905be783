"""The port's fused separable conv (``ops/cuda/sepconv.py``) against the
JAX package's Pallas ``fused_sepconv`` in interpret mode, on the same
numpy-made inputs.

On the CPU the wrapper runs the plain version (``sepconv_reference``);
the CUDA kernel is held against that on the card
(tests/test_torch_cuda.py).  float32: atol 1e-4, the JAX package's own
budget for this kernel (tests/test_sepconv_fused.py).  bfloat16: both
compute the depthwise in f32 from the same bf16 input and round y1 and
the pointwise weights to bf16, but they sum the nine taps and the
pointwise product in other orders, so a rounding of y1 or of the output
lands one bf16 ulp apart now and then; pinned at one ulp of the output
(measured: see ``BF16_TOL``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.ops.pallas.sepconv import \
    fused_sepconv as jfused
from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
from bugcar_image_segmentation_tpu_torch.ops.cuda.sepconv import (
    fold_bn, fused_sepconv, sepconv_reference)

# (h, w, c, f, strides, act_out): the JAX test's four shapes, then C and F
# off every tile size (the kernel's 32-channel chunks, 64-channel tiles)
# at both strides, as C = F = 728 is at the middle flow.
SHAPES = [(16, 32, 8, 16, 1, True), (16, 32, 8, 16, 2, False),
          (32, 64, 128, 128, 2, True), (8, 16, 24, 40, 1, False),
          (8, 16, 91, 45, 1, True), (8, 12, 91, 45, 2, False)]
IDS = ["-".join(map(str, s[:5])) + ("-relu" if s[5] else "") for s in SHAPES]
# bf16 port vs JAX: |diff| <= atol + rtol * |jax|.  Measured on these
# shapes: at most 0.0062 * |jax| (one ulp of the output), and at least
# 0.99991 of the outputs bit-equal.
BF16_TOL = (0.0, 2 ** -7)
BF16_EQUAL = 0.999


def _args(seed, n, h, w, c, f):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wdw = (rng.standard_normal((3, 3, 1, c)) * 0.3).astype(np.float32)
    wpw = (rng.standard_normal((c, f)) / np.sqrt(c)).astype(np.float32)
    s1 = rng.uniform(0.7, 1.3, c).astype(np.float32)
    b1 = rng.uniform(-0.1, 0.1, c).astype(np.float32)
    s2 = rng.uniform(0.7, 1.3, f).astype(np.float32)
    b2 = rng.uniform(-0.1, 0.1, f).astype(np.float32)
    return x, (wdw, s1, b1, wpw, s2, b2)


def _jax(x, weights, strides, act_out, dtype=jnp.float32):
    got = jfused(jnp.asarray(x, dtype), *map(jnp.asarray, weights),
                 strides=strides, act_out=act_out)
    return np.asarray(got.astype(jnp.float32))


def _port(fn, x, weights, strides, act_out, dtype=torch.float32):
    got = fn(torch.from_numpy(x).to(dtype), *map(torch.from_numpy, weights),
             strides=strides, act_out=act_out)
    assert got.dtype == dtype and got.is_contiguous()
    return got.float().numpy()


@pytest.mark.parametrize("h,w,c,f,strides,act", SHAPES, ids=IDS)
def test_f32_matches_pallas_interpret(h, w, c, f, strides, act):
    x, weights = _args(SHAPES.index((h, w, c, f, strides, act)), 2, h, w,
                       c, f)
    want = _jax(x, weights, strides, act)
    assert want.shape == (2, h // strides, w // strides, f)
    before = kcuda.LAUNCHES["fused_sepconv"]
    for fn in (fused_sepconv, sepconv_reference):
        got = _port(fn, x, weights, strides, act)
        np.testing.assert_allclose(got, want, atol=1e-4)
    # the CPU wrapper runs the plain version and launches nothing
    assert kcuda.LAUNCHES["fused_sepconv"] == before
    # N = 1 (the JAX kernel's direct, vmap-free path)
    np.testing.assert_allclose(
        _port(fused_sepconv, x[:1], weights, strides, act),
        _jax(x[:1], weights, strides, act), atol=1e-4)


@pytest.mark.parametrize("h,w,c,f,strides,act", SHAPES, ids=IDS)
def test_bf16_matches_pallas_interpret(h, w, c, f, strides, act):
    x, weights = _args(10 + SHAPES.index((h, w, c, f, strides, act)), 2, h,
                       w, c, f)
    xb = np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))
    want = _jax(xb, weights, strides, act, jnp.bfloat16)
    got = _port(fused_sepconv, xb, weights, strides, act, torch.bfloat16)
    atol, rtol = BF16_TOL
    assert np.all(np.abs(got - want) <= atol + rtol * np.abs(want)), \
        float(np.abs(got - want).max())
    # most outputs are bit-equal: the two differ only at rounding ties
    assert float((got == want).mean()) >= BF16_EQUAL


def test_plain_version_rounds_where_the_kernel_rounds():
    """bf16: y1 and the pointwise weights are rounded to bf16 before an
    f32 product; the result is cast once."""
    x, (wdw, s1, b1, wpw, s2, b2) = _args(3, 1, 6, 8, 16, 24)
    xb = torch.from_numpy(x).bfloat16()
    got = sepconv_reference(xb, *map(torch.from_numpy,
                                     (wdw, s1, b1, wpw, s2, b2)))
    xf = xb.float().permute(0, 3, 1, 2)
    taps = torch.from_numpy(wdw).reshape(3, 3, 16).permute(2, 0, 1)[:, None]
    y1 = torch.nn.functional.conv2d(xf, taps, padding=1, groups=16)
    y1 = torch.relu(y1.permute(0, 2, 3, 1) * torch.from_numpy(s1)
                    + torch.from_numpy(b1)).bfloat16().float()
    y2 = y1 @ torch.from_numpy(wpw).bfloat16().float()
    want = torch.relu(y2 * torch.from_numpy(s2) + torch.from_numpy(b2))
    torch.testing.assert_close(got, want.bfloat16(), rtol=0, atol=0)


def test_fold_bn_matches_the_flax_fold():
    """fold_bn is fastconv.FoldedBNParams' algebra: k = scale /
    sqrt(var + 1e-3), bias - mean * k, in f32."""
    rng = np.random.default_rng(4)
    scale, bias, mean = (rng.standard_normal(7).astype(np.float32)
                         for _ in range(3))
    var = rng.uniform(0.5, 1.5, 7).astype(np.float32)
    k, c = fold_bn({"scale": torch.from_numpy(scale),
                    "bias": torch.from_numpy(bias)},
                   {"mean": torch.from_numpy(mean),
                    "var": torch.from_numpy(var)})
    jk = jnp.asarray(scale) / jnp.sqrt(jnp.asarray(var) + 1e-3)
    np.testing.assert_allclose(k.numpy(), np.asarray(jk), rtol=1e-6)
    np.testing.assert_allclose(
        c.numpy(), np.asarray(jnp.asarray(bias) - jnp.asarray(mean) * jk),
        rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("fn", [fused_sepconv, sepconv_reference])
def test_rejects_bad_strides(fn):
    z8 = torch.zeros(8)
    with pytest.raises(ValueError, match="strides"):
        fn(torch.zeros(1, 8, 8, 8), torch.zeros(3, 3, 1, 8), z8, z8,
           torch.zeros(8, 8), z8, z8, strides=3)
    with pytest.raises(ValueError, match="even"):
        fn(torch.zeros(1, 7, 8, 8), torch.zeros(3, 3, 1, 8), z8, z8,
           torch.zeros(8, 8), z8, z8, strides=2)
    with pytest.raises(ValueError, match="even"):
        fn(torch.zeros(1, 8, 5, 8), torch.zeros(3, 3, 1, 8), z8, z8,
           torch.zeros(8, 8), z8, z8, strides=2)
