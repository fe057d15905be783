"""The port's W8A8 int8 matmul (``ops/quant.py``) against the JAX
package's ``ops/quant.py``, on the same numpy inputs: the quantized
values, the scales and ``int8_matmul`` are bit-equal (exact f32 scale
divisions, round half to even, int32 sums), including all-zero rows and
columns (the 1e-12 scale floor), values exactly on .5 of a step, and
clipping at +-127.  The gate (K, N >= 512) is the JAX ``Int8Dense``'s.
The ``torch._int_mm`` side of ``int8_mm`` runs only on the card
(tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.ops import quant as jq
from bugcar_image_segmentation_tpu_torch.ops import quant as pq


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(seed, m, k, n):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((m, k)) * 3).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    x[1] = 0.0                  # an all-zero token: the scale floor
    w[:, 2] = 0.0               # an all-zero output channel
    # exact ties: a row or column whose amax is 127 has scale 1.0, so
    # its x.5 values round half to even
    x[3, :8] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -126.5, 3.5]
    w[:6, 4] = [127.0, 0.5, 1.5, 2.5, -0.5, -126.5]
    return x, w


def _equal(j, t):
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("m,k,n", [(37, 512, 640), (8, 64, 24),
                                   (300, 728, 1024)])
def test_quantize_and_matmul_bit_equal(m, k, n):
    x, w = _inputs(m + k + n, m, k, n)
    for j, t in zip(jq.quantize_activation_int8(jnp.asarray(x)),
                    pq.quantize_activation_int8(torch.from_numpy(x))):
        _equal(j, t)
    for j, t in zip(jq.quantize_weight_int8(jnp.asarray(w)),
                    pq.quantize_weight_int8(torch.from_numpy(w))):
        _equal(j, t)
    got = pq.int8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == (m, n)
    _equal(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w)), got)
    # batched leading axes, as Int8Conv1x1 feeds pixels
    x3 = x[:36].reshape(2, 18, k) if m >= 36 else x[None]
    _equal(jq.int8_matmul(jnp.asarray(x3), jnp.asarray(w)),
           pq.int8_matmul(torch.from_numpy(x3), torch.from_numpy(w)))


def test_ties_and_floor_values():
    x, w = _inputs(0, 8, 64, 24)
    x_q, x_s = pq.quantize_activation_int8(torch.from_numpy(x))
    assert x_s[3, 0] == 1.0
    assert x_q[3, :8].tolist() == [127, 0, 2, 2, 0, -2, -126, 4]
    assert x_s[1, 0] == np.float32(1e-12) and not x_q[1].any()
    w_q, w_s = pq.quantize_weight_int8(torch.from_numpy(w))
    assert w_s[2] == np.float32(1e-12) and not w_q[:, 2].any()
    assert w_s[4] == 1.0 and w_q[:6, 4].tolist() == [127, 0, 2, 2, 0, -126]
    # clipped: a value past 127 steps of its row's scale cannot occur, the
    # scale is the row's amax / 127; the clip keeps -amax at -127
    assert int(x_q.min()) >= -127 and int(w_q.min()) >= -127


def test_product_is_exact_int32():
    rng = np.random.default_rng(3)
    a = torch.from_numpy(rng.integers(-127, 128, (19, 2048), np.int8))
    b = torch.from_numpy(rng.integers(-127, 128, (2048, 40), np.int8))
    got = pq.int8_mm(a, b)
    assert got.dtype == torch.int32
    assert torch.equal(got.long(), a.long() @ b.long())
    with pytest.raises(ValueError, match="int8"):
        pq.int8_mm(a.float(), b)


@pytest.mark.parametrize("k,n,want", [(512, 512, True), (511, 512, False),
                                      (512, 511, False), (2048, 768, True),
                                      (320, 768, False)])
def test_gate_is_int8_dense_gate(k, n, want):
    """pq.gated is Int8Dense's min_k = min_n = 512; below it the JAX
    module computes in float, above it by int8_matmul."""
    assert pq.gated(k, n) is want
    x, w = _inputs(k + n, 4, k, n)
    v = {"params": {"kernel": jnp.asarray(w), "bias": jnp.zeros(n)}}
    y = np.asarray(jq.Int8Dense(n, dtype=jnp.float32).apply(
        v, jnp.asarray(x)))
    q = np.asarray(jq.int8_matmul(jnp.asarray(x), jnp.asarray(w)))
    assert np.array_equal(y, q) is want
