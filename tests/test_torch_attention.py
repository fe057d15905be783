"""The port's flash attention (``ops/cuda/attention.py``) and the head's
bilinear upsample (``ops/resize.upsample_bilinear``) against the JAX
package.

On the CPU the attention wrappers run their plain version; the JAX
functions run the Pallas kernels in interpret mode, as the JAX package's
own tests do (tests/test_models.py ``TestFlashAttention``), on the same
numpy inputs.  Tolerance: float32 atol 2e-5, the JAX tests' own; bf16
within one bf16 ulp (both compute in f32 from the same operands and round
once).  The kernels themselves run only on the card
(tests/test_torch_cuda.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.ops.pallas import attention as jatt
from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
from bugcar_image_segmentation_tpu_torch.ops.cuda import attention as att
from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild
from bugcar_image_segmentation_tpu_torch.ops.resize import upsample_bilinear

ATOL = 2e-5


def _qkv(b, h, nq, nkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, h, nq, d)).astype(np.float32),
            rng.standard_normal((b, h, nkv, d)).astype(np.float32),
            rng.standard_normal((b, h, nkv, d)).astype(np.float32))


def _t(a):
    return np.ascontiguousarray(np.swapaxes(a, -1, -2))


@pytest.mark.parametrize("nq,nkv,bq,bkv", [
    (128, 128, 64, 64),    # even blocks
    (128, 96, 64, 32),     # cross-attention shape
    (100, 80, 64, 32),     # ragged -> divisor fallback
    (64, 2304, 64, 256),   # Nkv > 2048: many kv blocks of the recurrence
])
def test_flash_attention_matches_jax(nq, nkv, bq, bkv):
    q, k, v = _qkv(2, 2, nq, nkv, 32)
    want = np.asarray(jatt.flash_attention(q, k, v, block_q=bq,
                                           block_kv=bkv))
    before = dict(kcuda.LAUNCHES)
    got = att.flash_attention(*map(torch.from_numpy, (q, k, v)))
    assert kcuda.LAUNCHES == before    # CPU tensors: the plain version
    assert got.dtype == torch.float32 and got.shape == (2, 2, nq, 32)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("nq,nkv,bq,bkv", [
    (128, 128, 64, 64),
    (128, 96, 64, 32),
    (100, 80, 64, 32),
    (128, 96, 64, 96),     # bkv == nkv: the JAX single-pass kernel
    (256, 128, 256, 128),
    (64, 2304, None, None),  # default blocks: Nkv > 2048 goes blocked
])
def test_flash_attention_t_matches_jax(nq, nkv, bq, bkv):
    q, k, v = _qkv(2, 2, nq, nkv, 32, seed=1)
    qt, kt, vt = _t(q), _t(k), _t(v)
    want = np.asarray(jatt.flash_attention_t(qt, kt, vt, block_q=bq,
                                             block_kv=bkv))
    got = att.flash_attention_t(*map(torch.from_numpy, (qt, kt, vt)))
    assert got.shape == (2, 2, 32, nq) and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("d", [16, 32, 64])
def test_extreme_logits_stable(d):
    """Scores in the thousands: both layouts give exactly the softmax of
    the top half of the keys (all values 1)."""
    q = np.full((1, 1, 64, d), 30.0, np.float32)
    k = np.concatenate([np.full((1, 1, 32, d), 30.0, np.float32),
                        np.full((1, 1, 32, d), -30.0, np.float32)], axis=2)
    v = np.ones((1, 1, 64, d), np.float32)
    want = np.asarray(jatt.flash_attention(q, k, v, block_q=64, block_kv=32))
    got = att.flash_attention(*map(torch.from_numpy, (q, k, v))).numpy()
    got_t = att.flash_attention_t(*map(torch.from_numpy,
                                       (_t(q), _t(k), _t(v)))).numpy()
    assert np.isfinite(got).all() and np.isfinite(got_t).all()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(got_t, _t(want), atol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_reference_matches_jax(dtype):
    q, k, v = _qkv(1, 3, 70, 50, 64, seed=2)
    jq, jk, jv = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    want = np.asarray(jatt.attention_reference(jq, jk, jv).astype(
        jnp.float32))
    tq, tk, tv = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(
        getattr(torch, dtype)) for a in (jq, jk, jv))
    got = att.attention_reference(tq, tk, tv)
    assert got.dtype == getattr(torch, dtype)
    got = got.float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    else:
        assert (np.abs(got - want) <= 2.0 ** -7 * np.abs(want)
                + 1e-6).all()


def test_kernel_launch_checks_reject_cpu_tensors_and_bad_shapes():
    """``launch_args`` (the CUDA path's checks) refuses what the kernel
    does not take, before touching the library; the plain version on the
    CPU takes any head dim."""
    q, k, v = map(torch.from_numpy, _qkv(1, 2, 8, 8, 32))
    with pytest.raises(ValueError, match="CUDA tensor"):
        att.launch_args("flash_attention", q, k, v, torch.empty_like(q))
    q48, k48, v48 = map(torch.from_numpy, _qkv(1, 2, 8, 8, 48))
    assert att.flash_attention(q48, k48, v48).shape == (1, 2, 8, 48)
    assert att.HEAD_DIMS == (32, 64)
    assert {"flash_attention", "flash_attention_t"} <= set(kcuda.LAUNCHES)


def test_one_source_two_c_entry_points():
    """Both functions come from one CUDA source, built with the others
    into the one library: two C entry points, templated on the layout."""
    src = (kbuild.SOURCE_DIR / "flash_attention.cu").read_text()
    for sym in ("int bugcar_flash_attention(", "int bugcar_flash_attention_t("):
        assert sym in src
    assert "kChannelMajor" in src and "sm_90a" in " ".join(kbuild.NVCC_FLAGS)
    assert kbuild.SOURCE_DIR / "flash_attention.cu" in sorted(
        kbuild.SOURCE_DIR.glob("*.cu"))


# -- the head's bilinear upsample -----------------------------------------

# (h, w) -> (H, W): the SegFormer head's shapes (stages 1-3 to 1/4 res,
# the final x4), square and 2:1, and one axis left alone.
RESIZE_CASES = [((2, 2), (16, 16)), ((4, 4), (16, 16)), ((8, 8), (16, 16)),
                ((16, 16), (64, 64)), ((4, 8), (32, 64)), ((8, 16), (32, 64)),
                ((16, 32), (64, 128)), ((8, 4), (64, 16)), ((8, 8), (8, 32))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("src,dst", RESIZE_CASES,
                         ids=[f"{a[0]}x{a[1]}-{b[0]}x{b[1]}"
                              for a, b in RESIZE_CASES])
def test_upsample_bilinear_matches_jax_image_resize(src, dst, dtype):
    """float32: within 1e-6 (the two sum the same two products, XLA may
    fuse them); bfloat16: bit-equal — rounded after each axis, in the
    order JAX's einsum contracts them."""
    x = np.random.default_rng(3).standard_normal(
        (2, *src, 24)).astype(np.float32)
    xj = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax.image.resize(xj, (2, *dst, 24), method="bilinear")
                      .astype(jnp.float32))
    xt = torch.from_numpy(np.array(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))
    got = upsample_bilinear(xt, dst, axes=(1, 2))
    assert got.dtype == xt.dtype and got.shape == (2, *dst, 24)
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    else:
        np.testing.assert_array_equal(got.float().numpy(), want)
    # trailing-axes default on the NCHW view: the same numbers
    got_nchw = upsample_bilinear(xt.permute(0, 3, 1, 2), dst)
    torch.testing.assert_close(got_nchw.permute(0, 2, 3, 1), got, rtol=0,
                               atol=0)


def test_upsample_bilinear_refuses_to_shrink():
    with pytest.raises(ValueError, match="shrinks"):
        upsample_bilinear(torch.zeros(1, 8, 8), (4, 8))
