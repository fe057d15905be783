"""The arithmetic of the tensor-core flash attention (``csrc/flash_attention.cu``,
``flash_attention_wgmma``: bf16, token-major and channel-major), emulated in
torch on the CPU.

The kernel itself runs only on the card (tests/test_torch_cuda.py).  This
file holds its arithmetic -- K/V tiles of 64 keys (the kernel's
``kKeys``), an online softmax with exp2 on ``s * scale * log2 e``, P split
into bf16 ``P_hi + P_lo`` for two products into one f32 accumulator, one
cast at the end -- against the plain version (``attention_reference``)
under chip_smoke.py's bf16 budget, |got - ref| <= 1e-5 + 2^-7 |ref| (one
output ulp: both compute in f32 from the same bf16 operands and round
once), and against the JAX Pallas ``flash_attention`` in interpret mode.
It also pins why P is split: with a single bf16 P the same loop breaks the
budget wherever the output is near 0.  The channel-major kernel
(``flash_attention_t``) runs the same loop on [channel][token] tiles, so
the same emulation on transposed operands is held against
``attention_reference_t`` and against the Pallas ``flash_attention_t`` in
both its single-pass and its blocked regime.  The ``test_wgmma_*`` cases
widen the coverage to the shapes the wgmma kernel's card tests take (both
head dims in both layouts, ragged last tiles, several tiles of extreme
or saturated scores).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.ops.pallas import attention as jatt
from bugcar_image_segmentation_tpu_torch.ops.cuda import attention as att

ATOL, RTOL = 1e-5, 2 ** -7      # chip_smoke.py ATTN_TOL["bfloat16"]
TILE = 64                       # keys per K/V tile (the kernel's kKeys)
LOG2E = 1.4426950408889634


def emulate(q, k, v, split_p=True, p_dtype=torch.bfloat16):
    """The kernel's arithmetic on bf16 (B, H, N, d) operands: bf16 in, bf16
    out, f32 in between; ``split_p=False`` multiplies V by a single P of
    ``p_dtype`` (V cast to it too)."""
    d = q.shape[-1]
    c = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32) * torch.tensor(
        LOG2E, dtype=torch.float32)
    qf, kf, vf = q.float(), k.float(), v.float()
    m = torch.full(q.shape[:-1], -math.inf)
    l = torch.zeros(q.shape[:-1])
    o = torch.zeros(qf.shape)
    for j0 in range(0, k.shape[-2], TILE):
        s = qf @ kf[..., j0:j0 + TILE, :].transpose(-1, -2)   # f32 scores
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        vt = vf[..., j0:j0 + TILE, :]
        if split_p:
            hi = p.bfloat16().float()
            lo = (p - hi).bfloat16().float()
            o = o * alpha[..., None] + hi @ vt + lo @ vt
        else:
            o = o * alpha[..., None] + (p.to(p_dtype).float()
                                        @ vt.to(p_dtype).float())
        m = m_new
    return (o / l[..., None]).bfloat16()


def _qkv(b, h, nq, nkv, d, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy((rng.standard_normal((b, h, n, d)) * scale)
                             .astype(np.float32)).bfloat16()
            for n in (nq, nkv, nkv)]


def _over(got, ref):
    """Share of outputs outside the budget, and the largest |error|."""
    diff = (got.float() - ref.float()).abs()
    over = diff > ATOL + RTOL * ref.float().abs()
    return float(over.float().mean()), float(diff.max())


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("nkv", [1, 37, 1000])
@pytest.mark.parametrize("nq", [1, 100])
def test_emulation_within_budget(nq, nkv, d):
    """Ragged Nq and Nkv (a last tile of 1, 37 or 40 keys), both head dims."""
    q, k, v = _qkv(2, 3, nq, nkv, d, seed=nq * 7 + nkv + d)
    share, err = _over(emulate(q, k, v), att.attention_reference(q, k, v))
    assert share == 0.0, (share, err)


def test_emulation_within_budget_at_segformer_stage():
    """Stage 0's shape cut to 4096 queries: d 32, Nkv 1024, seeded normal
    bf16 operands as chip_smoke.py makes them."""
    q, k, v = _qkv(1, 1, 4096, 1024, 32, seed=0)
    share, err = _over(emulate(q, k, v), att.attention_reference(q, k, v))
    assert share == 0.0, (share, err)
    assert err < 2 ** -9


@pytest.mark.parametrize("p_dtype,least", [(torch.bfloat16, 0.05),
                                           (torch.float16, 0.001)],
                         ids=["bf16", "fp16"])
def test_single_p_breaks_the_budget(p_dtype, least):
    """The reason for the split: the same loop with one P misses the
    one-ulp budget on a measurable share of stage 0's outputs -- 10.5 %
    with bf16, 0.3 % even with fp16's 11 bits (V in fp16 too)."""
    q, k, v = _qkv(1, 1, 4096, 1024, 32, seed=0)
    share, _ = _over(emulate(q, k, v, split_p=False, p_dtype=p_dtype),
                     att.attention_reference(q, k, v))
    assert share > least, share


@pytest.mark.parametrize("scale", [8.0, 30.0])
def test_emulation_extreme_logits(scale):
    """Scores in the hundreds to thousands: the running max keeps every exp
    finite, and the result stays within the budget."""
    q, k, v = _qkv(1, 2, 70, 130, 32, seed=5, scale=math.sqrt(scale))
    got = emulate(q, k, v)
    assert bool(torch.isfinite(got.float()).all())
    share, err = _over(got, att.attention_reference(q, k, v))
    assert share == 0.0, (share, err)


def test_emulation_saturated_softmax():
    """All the weight on the top half of the keys, values 1: exactly 1."""
    q = torch.full((1, 1, 64, 32), 30.0).bfloat16()
    k = torch.cat([torch.full((1, 1, 32, 32), 30.0),
                   torch.full((1, 1, 32, 32), -30.0)], dim=2).bfloat16()
    v = torch.ones(1, 1, 64, 32).bfloat16()
    assert torch.equal(emulate(q, k, v), torch.ones(1, 1, 64, 32).bfloat16())


def test_emulation_matches_pallas_interpret():
    """The JAX package's Pallas kernel (interpret mode, f32 operands that are
    bf16 values) against the emulation, under the same budget."""
    q, k, v = _qkv(2, 2, 128, 96, 32, seed=3)
    want = np.asarray(jatt.flash_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        block_q=64, block_kv=32))
    got = emulate(q, k, v).float().numpy()
    assert (np.abs(got - want) <= ATOL + RTOL * np.abs(want)).all()


def emulate_t(q, k, v):
    """The channel-major kernel: the same arithmetic on (B, H, d, N)."""
    out = emulate(*(t.transpose(-1, -2) for t in (q, k, v)))
    return out.transpose(-1, -2).contiguous()


def _qkv_t(b, h, nq, nkv, d, seed):
    return [t.transpose(-1, -2).contiguous()
            for t in _qkv(b, h, nq, nkv, d, seed)]


@pytest.mark.parametrize("nkv", [1, 37, 1000])
@pytest.mark.parametrize("nq", [1, 100, 130])
def test_emulation_t_within_budget_ragged(nq, nkv):
    """Channel-major at ragged Nq and Nkv (Nq, Nkv not multiples of 8: the
    kernel loads those tiles element by element)."""
    q, k, v = _qkv_t(2, 3, nq, nkv, 32, seed=nq + 3 * nkv)
    share, err = _over(emulate_t(q, k, v), att.attention_reference_t(q, k, v))
    assert share == 0.0, (share, err)


@pytest.mark.parametrize("h,nq", [(2, 2048), (5, 1024), (8, 512)],
                         ids=["stage1", "stage2", "stage3"])
def test_emulation_t_within_budget_at_segformer_stages(h, nq):
    """SegFormer-B0's stages 1-3 (heads 2 / 5 / 8, d 32, 1024 keys) with the
    queries cut 8x / 4x / 2x, seeded normal bf16 operands."""
    q, k, v = _qkv_t(1, h, nq, 1024, 32, seed=h)
    share, err = _over(emulate_t(q, k, v), att.attention_reference_t(q, k, v))
    assert share == 0.0, (share, err)
    assert err < 2 ** -9


@pytest.mark.parametrize("block_kv", [None, 32], ids=["single-pass", "blocked"])
def test_emulation_t_matches_pallas_interpret(block_kv):
    """The JAX package's channel-major Pallas kernel (interpret mode, f32
    operands that are bf16 values): all keys in one block (Nkv <= 2048,
    its single-pass kernel) or blocks of 32 keys (its online-softmax
    kernel), against the emulation under the same budget."""
    q, k, v = _qkv_t(1, 2, 128, 96, 32, seed=4)
    want = np.asarray(jatt.flash_attention_t(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        block_q=64, block_kv=block_kv))
    got = emulate_t(q, k, v).float().numpy()
    assert (np.abs(got - want) <= ATOL + RTOL * np.abs(want)).all()


# -- the wgmma kernel's card-test shapes --------------------------------------


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("nkv", [1, 37, 130, 1000])
@pytest.mark.parametrize("nq", [1, 100, 130])
def test_wgmma_within_budget(nq, nkv, d):
    """Ragged Nq and Nkv (a last tile of 1, 37, 2 or 40 keys), both head
    dims."""
    q, k, v = _qkv(2, 3, nq, nkv, d, seed=nq * 5 + nkv + d)
    share, err = _over(emulate(q, k, v), att.attention_reference(q, k, v))
    assert share == 0.0, (share, err)


@pytest.mark.parametrize("d", [32, 64])
def test_wgmma_within_budget_at_segformer_stage(d):
    """Stage 0's shape cut to 4096 queries at B0's head dim and B2's,
    seeded normal bf16 operands as chip_smoke.py makes them."""
    q, k, v = _qkv(1, 1, 4096, 1024, d, seed=0)
    share, err = _over(emulate(q, k, v), att.attention_reference(q, k, v))
    assert share == 0.0, (share, err)
    assert err < 2 ** -9


@pytest.mark.parametrize("p_dtype,least", [(torch.bfloat16, 0.05),
                                           (torch.float16, 0.001)],
                         ids=["bf16", "fp16"])
def test_wgmma_single_p_breaks_the_budget_at_d64(p_dtype, least):
    """The split is needed at B2's head dim too: one P of bf16 (or fp16)
    misses the one-ulp budget on a measurable share of stage 0's
    outputs."""
    q, k, v = _qkv(1, 1, 4096, 1024, 64, seed=0)
    share, _ = _over(emulate(q, k, v, split_p=False, p_dtype=p_dtype),
                     att.attention_reference(q, k, v))
    assert share > least, share


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("scale", [8.0, 30.0])
def test_wgmma_extreme_logits(scale, d):
    """Scores in the hundreds to thousands across four tiles (the last
    ragged): every exp stays finite, within the budget."""
    q, k, v = _qkv(1, 2, 70, 200, d, seed=6, scale=math.sqrt(scale))
    got = emulate(q, k, v)
    assert bool(torch.isfinite(got.float()).all())
    share, err = _over(got, att.attention_reference(q, k, v))
    assert share == 0.0, (share, err)


@pytest.mark.parametrize("nkv", [64, 256], ids=["one-tile", "four-tiles"])
def test_wgmma_saturated_softmax(nkv):
    """All the weight on the first half of the keys (half a tile, or the
    first two tiles), values 1: exactly 1."""
    q = torch.full((1, 1, 64, 32), 30.0).bfloat16()
    k = torch.cat([torch.full((1, 1, nkv // 2, 32), 30.0),
                   torch.full((1, 1, nkv // 2, 32), -30.0)], dim=2).bfloat16()
    v = torch.ones(1, 1, nkv, 32).bfloat16()
    assert torch.equal(emulate(q, k, v), torch.ones(1, 1, 64, 32).bfloat16())


@pytest.mark.parametrize("nkv,block_kv", [(96, 32), (300, 64)],
                         ids=["two-tiles", "five-tiles"])
def test_wgmma_matches_pallas_interpret(nkv, block_kv):
    """The JAX package's Pallas kernel (interpret mode, f32 operands that are
    bf16 values) against the emulation over ragged tiles, under the same
    budget."""
    q, k, v = _qkv(2, 2, 128, nkv, 32, seed=7)
    want = np.asarray(jatt.flash_attention(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        block_q=64, block_kv=block_kv))
    got = emulate(q, k, v).float().numpy()
    assert (np.abs(got - want) <= ATOL + RTOL * np.abs(want)).all()


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("nkv", [1, 37, 1000])
@pytest.mark.parametrize("nq", [1, 100, 130])
def test_wgmma_t_within_budget_ragged(nq, nkv, d):
    """Channel-major at ragged Nq and Nkv (not multiples of 8: the kernel's
    producer loads those tiles element by element), both head dims."""
    q, k, v = _qkv_t(2, 3, nq, nkv, d, seed=nq + 3 * nkv + d)
    share, err = _over(emulate_t(q, k, v), att.attention_reference_t(q, k, v))
    assert share == 0.0, (share, err)


@pytest.mark.parametrize("d", [32, 64])
@pytest.mark.parametrize("h,nq", [(2, 2048), (5, 1024), (8, 512)],
                         ids=["stage1", "stage2", "stage3"])
def test_wgmma_t_within_budget_at_segformer_stages(h, nq, d):
    """SegFormer's stages 1-3 (heads 2 / 5 / 8, 1024 keys) with the queries
    cut 8x / 4x / 2x, at B0's head dim and B2's."""
    q, k, v = _qkv_t(1, h, nq, 1024, d, seed=h + d)
    share, err = _over(emulate_t(q, k, v), att.attention_reference_t(q, k, v))
    assert share == 0.0, (share, err)
    assert err < 2 ** -9


@pytest.mark.parametrize("block_kv", [None, 32], ids=["single-pass", "blocked"])
def test_wgmma_t_matches_pallas_interpret(block_kv):
    """The channel-major Pallas kernel in both regimes against the
    emulation on 300 keys (a ragged fifth tile)."""
    q, k, v = _qkv_t(1, 2, 128, 300, 32, seed=8)
    want = np.asarray(jatt.flash_attention_t(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
        block_q=64, block_kv=block_kv))
    got = emulate_t(q, k, v).float().numpy()
    assert (np.abs(got - want) <= ATOL + RTOL * np.abs(want)).all()
