"""The port's CUDA kernels on the card, against their plain PyTorch versions
(the ENet bottleneck, flash attention, the fused separable conv, the
Mosaic probes' strided gather and halo add), the SegFormer and Xception
engines on the card against their plain versions, batch invariance (a
frame's result alone equals its result in a batch, every engine family),
the camera rig, bench.py's path (``enet_w16``, host resize, i420) on
the card, the int8 product (``torch._int_mm``, exact against the int32
plain version, small M padded), the torch backend of the temporal
fusion on the card, training: bf16 ENet and SegFormer steps (the
latter through the plain attention), one f32 ENet step against the same
step on the CPU, and the data-parallel step on one NCCL rank; and the
serving kernels as ``torch.library`` ops (each op's CUDA implementation
against its plain version, an exported artifact's launches counted, a
failed build raising with no fallback).

Needs an NVIDIA card (Hopper, sm_90a) and nvcc; every test here skips
without a card.  This file imports neither JAX nor the JAX package, so it
runs on the GPU host, which has neither:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

Tolerances, |kernel - plain| <= atol + rtol * |plain|: float32 2e-4 / 2e-4
(the JAX package's own fused-bottleneck budget), with TF32 off so that the
plain version's convolutions are float32; bfloat16 2^-6 / 2^-5 — the two
versions sum in different orders, so a bf16 rounding of an intermediate
(y1, the 5x1 result, y2) can land one ulp apart and carry through.
"""

import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import (
    fused_bottleneck, fused_bottleneck_ref)

pytestmark = pytest.mark.cuda

KINDS = [("regular", 1), ("dilated", 2), ("dilated", 4), ("dilated", 8),
         ("dilated", 16), ("asymmetric", 1)]
TOL = {torch.float32: (2e-4, 2e-4), torch.bfloat16: (2 ** -6, 2 ** -5)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA CUDA card (run this file on the GPU "
                    "host)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _args(kind, seed, device, c=128, mid=32):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def vec(k, lo, hi):
        return t(rng.uniform(lo, hi, k))

    def kern(*shape):
        fan = int(np.prod(shape[:-1]))
        return t(rng.standard_normal(shape) / np.sqrt(fan))

    if kind == "asymmetric":
        core = (kern(5, 1, mid, mid), kern(1, 5, mid, mid))
    else:
        core = kern(3, 3, mid, mid)
    return [kern(c, mid), vec(mid, .5, 1.5), vec(mid, -.5, .5),
            vec(mid, 0, .5), core, vec(mid, .5, 1.5), vec(mid, -.5, .5),
            vec(mid, 0, .5), kern(mid, c), vec(c, .5, 1.5), vec(c, -.5, .5),
            vec(c, 0, .5)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(1, 32, 64), (4, 32, 64), (2, 6, 5),
                                   (3, 17, 9), (2, 5, 13), (1, 7, 70)],
                         ids=["main1", "main4", "smaller-than-halo", "odd",
                              "ragged", "partial-tile"])
@pytest.mark.parametrize("kind,dil", KINDS)
def test_kernel_matches_plain(dev, kind, dil, shape, dtype):
    n, h, w = shape
    args = _args(kind, KINDS.index((kind, dil)), dev)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (n, h, w, 128)).astype(np.float32), device=dev).to(dtype)
    before = kcuda.LAUNCHES["fused_bottleneck"]
    got = fused_bottleneck(x, *args, kind=kind, dilation=dil)
    assert kcuda.LAUNCHES["fused_bottleneck"] == before + 1
    ref = fused_bottleneck_ref(x, *args, kind=kind, dilation=dil)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == x.shape
    atol, rtol = TOL[dtype]
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= atol + rtol * ref.float().abs()).all()), \
        float(diff.max())


def test_asymmetric_core_pair_shared_or_separate(dev):
    """The 5x1/1x5 pair may be views of one buffer (passed as it is) or
    two separate tensors (concatenated first): the same result."""
    args = _args("asymmetric", 7, dev)
    w51, w15 = args[4]
    both = torch.cat([w51.reshape(-1), w15.reshape(-1)])
    shared = list(args)
    shared[4] = (both[:w51.numel()].view(w51.shape),
                 both[w51.numel():].view(w15.shape))
    x = torch.randn(1, 8, 16, 128, device=dev)
    a = fused_bottleneck(x, *args, kind="asymmetric")
    b = fused_bottleneck(x, *shared, kind="asymmetric")
    torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("bad", ["dtype", "width", "noncontig", "wdtype",
                                 "wdevice", "packed_dtype", "packed_shape",
                                 "packed_device"])
def test_wrapper_rejects(dev, bad):
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import \
        pack_weights
    args = _args("regular", 3, dev)
    x = torch.randn(1, 8, 8, 128, device=dev)
    kw = {}
    if bad.startswith("packed"):   # the bf16 kernel's weights
        x = x.bfloat16()
        packed = pack_weights(args[0], args[4], args[8])
        kw["packed"] = {"packed_dtype": packed.float(),
                        "packed_shape": packed[:-8],
                        "packed_device": packed.cpu()}[bad]
    if bad == "dtype":
        x = x.half()
    elif bad == "width":
        x = torch.randn(1, 8, 8, 64, device=dev)
    elif bad == "noncontig":
        x = torch.randn(1, 8, 128, 8, device=dev).transpose(2, 3)
    elif bad == "wdtype":
        args[0] = args[0].double()
    elif bad == "wdevice":
        args[0] = args[0].cpu()
    before = kcuda.LAUNCHES["fused_bottleneck"]
    with pytest.raises(ValueError):
        fused_bottleneck(x, *args, kind="regular", **kw)
    assert kcuda.LAUNCHES["fused_bottleneck"] == before


@pytest.mark.parametrize("kind,dil", KINDS)
def test_bottleneck_frame_alone_equals_frame_in_batch(dev, kind, dil):
    """bf16 at the path's shape: frame 0 alone and inside a batch of 4 are
    bit-equal (the launch plan depends on (h, w, kind, d) only)."""
    args = _args(kind, 20 + KINDS.index((kind, dil)), dev)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (4, 32, 64, 128)).astype(np.float32), device=dev).bfloat16()
    batch = fused_bottleneck(x, *args, kind=kind, dilation=dil)
    alone = fused_bottleneck(x[:1].contiguous(), *args, kind=kind,
                             dilation=dil)
    torch.cuda.synchronize()
    assert torch.equal(alone, batch[:1])


@pytest.mark.parametrize("kind,dil", [("dilated", 16), ("asymmetric", 1)])
def test_bottleneck_packed_once_equals_packed_per_call(dev, kind, dil):
    """FusedBlock's weights packed once at construction give the same bits
    as the wrapper packing them at the call, and the same launch count."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import \
        pack_weights
    args = _args(kind, 30, dev)
    packed = pack_weights(args[0], args[4], args[8], kind=kind)
    x = torch.randn(2, 32, 64, 128, device=dev).bfloat16()
    before = kcuda.LAUNCHES["fused_bottleneck"]
    a = fused_bottleneck(x, *args, kind=kind, dilation=dil, packed=packed)
    b = fused_bottleneck(x, *args, kind=kind, dilation=dil)
    assert kcuda.LAUNCHES["fused_bottleneck"] == before + 2
    assert torch.equal(a, b)


@pytest.mark.parametrize("dil,hw", [(32, (40, 24)), (24, (9, 64))],
                         ids=["d-over-w", "windows"])
def test_bottleneck_large_dilation(dev, dil, hw):
    """d >= w: the side taps of the 3x3 fall off the image for every pixel
    (the kernel skips them); 16 < d < w: the tile is the three 16-column
    windows the taps read.  Within the budget of the plain version, in
    bf16 and f32."""
    args = _args("dilated", 31, dev)
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn(1, *hw, 128, device=dev).to(dtype)
        got = fused_bottleneck(x, *args, kind="dilated", dilation=dil)
        ref = fused_bottleneck_ref(x, *args, kind="dilated", dilation=dil)
        torch.cuda.synchronize()
        atol, rtol = TOL[dtype]
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= atol + rtol * ref.float().abs()).all()), \
            float(diff.max())


@pytest.mark.parametrize("shape", [(1, 32, 64), (4, 32, 64), (2, 5, 13),
                                   (1, 7, 70)],
                         ids=["main1", "main4", "ragged", "partial-tile"])
@pytest.mark.parametrize("kind,dil", KINDS)
def test_bottleneck_bf16_bits_are_the_chain(dev, kind, dil, shape):
    """The bf16 kernel sums on the tensor cores but rounds y1, the 5x1
    result, y2 and the output as an f32 FMA chain over the input channels in
    order does: bit for bit the emulation of that chain
    (``fused_bottleneck_chain``), run here on the card."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import \
        fused_bottleneck_chain
    args = _args(kind, 40 + KINDS.index((kind, dil)), dev)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (*shape, 128)).astype(np.float32), device=dev).bfloat16()
    got = fused_bottleneck(x, *args, kind=kind, dilation=dil)
    want = fused_bottleneck_chain(x, *args, kind=kind, dilation=dil)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16)), \
        int((got.view(torch.int16) != want.view(torch.int16)).sum())


@pytest.mark.parametrize("kind,dil,cols", [
    ("regular", 1, 18), ("dilated", 2, 20), ("dilated", 4, 24),
    ("dilated", 8, 32), ("dilated", 16, 48), ("asymmetric", 1, 20)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_bottleneck_plan_at_the_path_shape(dev, kind, dil, cols, dtype):
    """At ENet's 32x64 trunk map every block launches 128 CTAs of 16
    pixels; the y1 tile is 16 + 2d columns (20 for the 1x5); the batch
    only repeats the grid (the plan the kernel source reports)."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import plan
    pl = plan(1, 32, 64, kind, dil, dtype)
    assert pl["ctas"] == 128 and pl["px_per_cta"] == 16
    assert pl["kernel"] == ("fused_bottleneck_mma" if dtype == torch.bfloat16
                            else "fused_bottleneck_tile")
    assert pl["threads"] == (256 if dtype == torch.bfloat16 else 512)
    assert pl["y1_tile"] == [5 if kind == "asymmetric" else 3, cols]
    assert plan(4, 32, 64, kind, dil, dtype)["ctas"] == 4 * pl["ctas"]


@pytest.mark.parametrize("dil,w,cols", [(24, 64, 48), (32, 24, 16),
                                        (64, 64, 16)])
def test_bottleneck_plan_large_dilations(dev, dil, w, cols):
    """16 < d < w: the three 16-column windows the taps read (48 columns);
    d >= w: the centre window alone (the side taps read only padding)."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import plan
    assert plan(1, 8, w, "dilated", dil)["y1_tile"] == [3, cols]


# -- flash attention -------------------------------------------------------
#
# |kernel - plain| <= atol + rtol * |plain|: float32 2e-5 / 0 (the JAX
# package's own flash-attention tolerance), TF32 off; bfloat16 1e-5 /
# 2^-7 — both versions compute in f32 from the same bf16 operands and
# round once, so they differ by at most one bf16 ulp (<= 2^-7 |x|).

ATTN_TOL = {torch.float32: (2e-5, 0.0), torch.bfloat16: (1e-5, 2 ** -7)}
# (B, H, Nq, Nkv, d): SegFormer-B0's four stages at 1024x1024, a B1-B3
# head dim, the blocked-recurrence regime of the JAX kernel (Nkv > 2048),
# and ragged / single-key shapes.
ATTN_SHAPES = [(1, 1, 65536, 1024, 32), (1, 2, 16384, 1024, 32),
               (1, 5, 4096, 1024, 32), (1, 8, 1024, 1024, 32),
               (1, 2, 16384, 1024, 64), (1, 1, 4096, 4096, 32),
               (2, 3, 1000, 77, 64), (1, 2, 130, 1, 32)]


def _qkv(shape, dtype, dev, seed=0):
    b, h, nq, nkv, d = shape
    rng = np.random.default_rng(seed)

    def t(*s):
        return torch.as_tensor(rng.standard_normal(s).astype(np.float32),
                               device=dev).to(dtype)

    return t(b, h, nq, d), t(b, h, nkv, d), t(b, h, nkv, d)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", ATTN_SHAPES,
                         ids=["-".join(map(str, s)) for s in ATTN_SHAPES])
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_t"])
def test_attention_kernel_matches_plain(dev, name, shape, dtype):
    from bugcar_image_segmentation_tpu_torch.ops.cuda import attention as att
    q, k, v = _qkv(shape, dtype, dev)
    if name == "flash_attention_t":
        q, k, v = (x.transpose(-1, -2).contiguous() for x in (q, k, v))
    fn = getattr(att, name)
    plain = (att.attention_reference_t if name == "flash_attention_t"
             else att.attention_reference)
    before = kcuda.LAUNCHES[name]
    got = fn(q, k, v)
    assert kcuda.LAUNCHES[name] == before + 1
    ref = plain(q, k, v)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    atol, rtol = ATTN_TOL[dtype]
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= atol + rtol * ref.float().abs()).all()), \
        float(diff.max())


def test_attention_extreme_logits(dev):
    """The online softmax survives scores in the thousands."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda.attention import \
        flash_attention
    q = torch.full((1, 1, 64, 32), 30.0, device=dev)
    k = torch.cat([torch.full((1, 1, 32, 32), 30.0, device=dev),
                   torch.full((1, 1, 32, 32), -30.0, device=dev)], dim=2)
    v = torch.ones(1, 1, 64, 32, device=dev)
    out = flash_attention(q, k, v)
    torch.testing.assert_close(out, torch.ones_like(out), rtol=0, atol=1e-5)


@pytest.mark.parametrize("bad", ["d48", "noncontig", "half", "kvshape",
                                 "device", "grad"])
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_t"])
def test_attention_wrapper_rejects(dev, name, bad):
    from bugcar_image_segmentation_tpu_torch.ops.cuda import attention as att
    d = 48 if bad == "d48" else 32
    q, k, v = _qkv((1, 2, 64, 32, d), torch.float32, dev)
    if name == "flash_attention_t":
        q, k, v = (x.transpose(-1, -2).contiguous() for x in (q, k, v))
    if bad == "noncontig":   # same shape and values, other strides
        q = q.transpose(-1, -2).contiguous().transpose(-1, -2)
    elif bad == "half":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "kvshape":
        v = v[..., :16].contiguous()
    elif bad == "device":
        k = k.cpu()
    elif bad == "grad":      # the kernel has no backward
        q.requires_grad_()
    before = kcuda.LAUNCHES[name]
    with pytest.raises(ValueError):
        getattr(att, name)(q, k, v)
    assert kcuda.LAUNCHES[name] == before


def test_segformer_engine_on_card_matches_plain_attention(dev):
    """SegFormer-B0 at 512x512 on the card, attention through the kernel
    against the same weights with ``xla_attention`` (the plain version):
    float32 logits within 1e-3 (TF32 off), bf16 labels agree on >= 0.98
    of pixels (the two round the attention output at different points;
    seeded random weights have many near-ties)."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
        random_segformer_variables
    variables = random_segformer_variables(0)
    frames = np.stack([f for f, _, _ in synthetic.video(
        seed=0, num_frames=2, shape=(480, 640))])
    for dtype in ("float32", "bfloat16"):
        cfg = port.ModelConfig(name="segformer_b0", input_width=512,
                               input_height=512, dtype=dtype)
        eng = port.build_engine("segformer_b0", cfg, variables=variables,
                                device="cuda")
        before = kcuda.LAUNCHES["flash_attention"] + \
            kcuda.LAUNCHES["flash_attention_t"]
        got = eng.logits(frames)
        after = kcuda.LAUNCHES["flash_attention"] + \
            kcuda.LAUNCHES["flash_attention_t"]
        # 8 launches per backbone forward; SegFormer runs frame by frame
        assert after - before == 8 * (len(frames) if eng.frame_by_frame
                                      else 1)
        eng.module.xla_attention = True
        ref = eng.logits(frames)
        assert bool(torch.isfinite(got).all())
        if dtype == "float32":
            assert float((got - ref).abs().max()) <= 1e-3
        else:
            agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            assert agree >= 0.98, agree


# -- fused separable conv --------------------------------------------------
#
# |kernel - plain| <= atol + rtol * |plain|, the bottleneck's budgets
# (TOL): float32 with TF32 off; bfloat16 — the two sum the nine taps and
# the pointwise product in other orders, so a bf16 rounding of y1 can land
# one ulp apart and carry through the product.

# (n, h, w, c, f, stride, act_out): the Xception path's site shapes at
# 1024x512 come in chip_smoke.py; here small, ragged (C, F off the 32 / 64
# tiles, odd maps, a tile spanning images) and stride 2 at C != 128.
SEP_SHAPES = [(1, 16, 32, 64, 128, 1, True), (2, 9, 13, 91, 45, 1, True),
              (3, 5, 7, 3, 5, 1, False), (2, 16, 32, 128, 128, 2, False),
              (1, 16, 24, 256, 256, 2, False), (1, 8, 16, 728, 728, 2, True),
              (2, 32, 64, 728, 728, 1, True), (1, 6, 10, 40, 70, 2, True)]


def _sep_args(shape, dtype, dev, seed=0):
    n, h, w, c, f, _, _ = shape
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    x = t(rng.standard_normal((n, h, w, c))).to(dtype)
    return x, [t(rng.standard_normal((3, 3, 1, c)) * 0.3),
               t(rng.uniform(0.7, 1.3, c)), t(rng.uniform(-0.1, 0.1, c)),
               t(rng.standard_normal((c, f)) / np.sqrt(c)),
               t(rng.uniform(0.7, 1.3, f)), t(rng.uniform(-0.1, 0.1, f))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SEP_SHAPES,
                         ids=["-".join(map(str, s[:6])) for s in SEP_SHAPES])
def test_sepconv_kernel_matches_plain(dev, shape, dtype):
    from bugcar_image_segmentation_tpu_torch.ops.cuda.sepconv import (
        fused_sepconv, sepconv_reference)
    n, h, w, c, f, stride, act = shape
    x, args = _sep_args(shape, dtype, dev)
    before = kcuda.LAUNCHES["fused_sepconv"]
    got = fused_sepconv(x, *args, strides=stride, act_out=act)
    assert kcuda.LAUNCHES["fused_sepconv"] == before + 1
    ref = sepconv_reference(x, *args, strides=stride, act_out=act)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (n, h // stride, w // stride,
                                                f)
    atol, rtol = TOL[dtype]
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= atol + rtol * ref.float().abs()).all()), \
        float(diff.max())


@pytest.mark.parametrize("bad", ["half", "noncontig", "oddh", "stride3",
                                 "wdevice", "wdtype", "wshape", "grad",
                                 "wgrad"])
def test_sepconv_wrapper_rejects(dev, bad):
    from bugcar_image_segmentation_tpu_torch.ops.cuda.sepconv import \
        fused_sepconv
    shape = (1, 8, 8, 32, 16, 2, True)
    x, args = _sep_args(shape, torch.float32, dev)
    stride = 2
    if bad == "half":
        x = x.half()
    elif bad == "noncontig":   # same shape and values, other strides
        x = x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1)
    elif bad == "oddh":
        x = x[:, :7].contiguous()
    elif bad == "stride3":
        stride = 3
    elif bad == "wdevice":
        args[3] = args[3].cpu()
    elif bad == "wdtype":
        args[0] = args[0].double()
    elif bad == "wshape":
        args[3] = args[3][:, :8].contiguous()
    elif bad == "grad":      # the kernel has no backward
        x.requires_grad_()
    elif bad == "wgrad":
        args[1].requires_grad_()
    before = kcuda.LAUNCHES["fused_sepconv"]
    with pytest.raises(ValueError):
        fused_sepconv(x, *args, strides=stride)
    assert kcuda.LAUNCHES["fused_sepconv"] == before


# -- the redesigned bf16 kernels: ragged ends, batch invariance, the sites --
#
# flash_attention's bf16 token-major path runs on the tensor cores (64 or,
# for one head with >= 33,792 queries, 128 queries a CTA); fused_sepconv's
# bf16 path on wgmma (8-row tiles) or mma.sync (4-row tiles, wide C), with
# the launch plan of ops/cuda/sepconv.plan.

MMA_SHAPES = [(1, 1, 37, 1000, 32), (3, 2, 65, 37, 64), (1, 1, 1, 1, 64),
              (2, 1, 129, 65, 32), (1, 1, 33850, 130, 32),
              (1, 2, 1000, 4097, 64)]


@pytest.mark.parametrize("shape", MMA_SHAPES,
                         ids=["-".join(map(str, s)) for s in MMA_SHAPES])
def test_attention_mma_ragged(dev, shape):
    """Ragged Nq and Nkv at both head dims and both CTA widths, bf16."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import attention as att
    q, k, v = _qkv(shape, torch.bfloat16, dev, seed=11)
    before = kcuda.LAUNCHES["flash_attention"]
    got = att.flash_attention(q, k, v)
    assert kcuda.LAUNCHES["flash_attention"] == before + 1
    ref = att.attention_reference(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL[torch.bfloat16]
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= atol + rtol * ref.float().abs()).all()), \
        float(diff.max())


@pytest.mark.parametrize("shape", [(4, 1, 4096, 1024, 32),
                                   (4, 1, 33850, 256, 32),
                                   (4, 2, 1000, 77, 64),
                                   (4, 8, 1024, 1024, 32)],
                         ids=["64rows", "128rows", "d64", "stage3"])
@pytest.mark.parametrize("name", ["flash_attention", "flash_attention_t"])
def test_attention_frame_alone_equals_frame_in_batch(dev, name, shape):
    """bf16: a frame's output alone and inside a batch of 4 are bit-equal."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import attention as att
    q, k, v = _qkv(shape, torch.bfloat16, dev, seed=12)
    if name == "flash_attention_t":
        q, k, v = (x.transpose(-1, -2).contiguous() for x in (q, k, v))
    fn = getattr(att, name)
    batch = fn(q, k, v)
    alone = fn(*(x[:1].contiguous() for x in (q, k, v)))
    torch.cuda.synchronize()
    assert torch.equal(alone, batch[:1])


# flash_attention_t's bf16 path runs the same tensor-core kernel on
# channel-major tiles: 16-byte vectors where Nq and Nkv are multiples of 8,
# element by element otherwise; 32, 64 or 128 queries a CTA.

@pytest.mark.parametrize("shape", MMA_SHAPES + [(2, 3, 1000, 77, 64),
                                                (1, 2, 130, 1, 32),
                                                (1, 8, 1024, 1024, 32)],
                         ids=["-".join(map(str, s)) for s in MMA_SHAPES]
                         + ["1000-77-d64", "130-1", "stage3"])
def test_attention_t_mma_ragged(dev, shape):
    """Channel-major bf16 at ragged Nq and Nkv, both head dims, every CTA
    width the plan takes, against the plain version (one ulp)."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import attention as att
    q, k, v = (x.transpose(-1, -2).contiguous()
               for x in _qkv(shape, torch.bfloat16, dev, seed=13))
    before = kcuda.LAUNCHES["flash_attention_t"]
    got = att.flash_attention_t(q, k, v)
    assert kcuda.LAUNCHES["flash_attention_t"] == before + 1
    ref = att.attention_reference_t(q, k, v)
    torch.cuda.synchronize()
    atol, rtol = ATTN_TOL[torch.bfloat16]
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= atol + rtol * ref.float().abs()).all()), \
        float(diff.max())


@pytest.mark.parametrize("shape", [(1, 8, 1024, 1024, 32),
                                   (1, 2, 1000, 77, 32),
                                   (2, 1, 300, 130, 64)],
                         ids=["stage3", "ragged", "d64"])
@pytest.mark.parametrize("channel_major", [False, True],
                         ids=["token", "channel"])
def test_attention_widths_bit_equal(dev, shape, channel_major):
    """Every CTA width (32, 64 and, at d = 32, 128 queries) gives the same
    bits: a query row runs the same instructions whatever the plan."""
    import ctypes
    import math

    from bugcar_image_segmentation_tpu_torch.ops.cuda import build
    b, h, nq, nkv, d = shape
    q, k, v = _qkv(shape, torch.bfloat16, dev, seed=14)
    if channel_major:
        q, k, v = (x.transpose(-1, -2).contiguous() for x in (q, k, v))
    lib = build.library()
    outs = []
    for rows in (32, 64, 128) if d == 32 else (32, 64):
        out = torch.empty_like(q)
        err = lib.bugcar_flash_attention_bf16_rows(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b * h,
            nq, nkv, d, ctypes.c_float(1.0 / math.sqrt(d)),
            int(channel_major), rows,
            torch.cuda.current_stream().cuda_stream)
        build.check(err, f"rows {rows}")
        outs.append(out)
    torch.cuda.synchronize()
    for out in outs[1:]:
        assert torch.equal(out, outs[0])


def _smoke_sites():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.SEP_SITES


# chip_smoke.py's ten site shapes (name, H, W, C, F, stride, act_out, _)
SEP_SITE_IDS = ["block1.sep0", "block1.sep1", "block1.sep2", "block2.sep0",
                "block2.sep1", "block3.sep0", "block3.sep1", "middle",
                "block2.sep2", "block3.sep2"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("site", range(len(SEP_SITE_IDS)), ids=SEP_SITE_IDS)
def test_sepconv_sites_match_plain_and_batch(dev, site, dtype):
    """Every site shape of the Xception path at 1024x512 (and the two
    stride-2 extras), N = 1 and 4, against the plain version; the frame
    alone equals the same frame in the batch of 4, bit for bit; one launch
    a call."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda.sepconv import (
        fused_sepconv, sepconv_reference)
    name, h, w, c, f, stride, act, _ = _smoke_sites()[site]
    assert name.split(" ")[0] == SEP_SITE_IDS[site]
    x, args = _sep_args((4, h, w, c, f, stride, act), dtype, dev, seed=site)
    atol, rtol = TOL[dtype]
    outs = {}
    for n in (1, 4):
        before = kcuda.LAUNCHES["fused_sepconv"]
        got = fused_sepconv(x[:n].contiguous(), *args, strides=stride,
                            act_out=act)
        assert kcuda.LAUNCHES["fused_sepconv"] == before + 1
        ref = sepconv_reference(x[:n].contiguous(), *args, strides=stride,
                                act_out=act)
        torch.cuda.synchronize()
        diff = (got.float() - ref.float()).abs()
        assert bool((diff <= atol + rtol * ref.float().abs()).all()), \
            float(diff.max())
        outs[n] = got
    assert torch.equal(outs[1], outs[4][:1])


@pytest.mark.parametrize("stride,f", [(1, 1536), (2, 728)])
def test_sepconv_wide_channels_bf16(dev, stride, f):
    """C = 1536: a 64-pixel y1 does not fit beside the window and the ring,
    so the plan takes 4-row tiles, whose pointwise runs on mma.sync; bf16
    against the plain version, and the first frame alone equals it in the
    batch."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda.sepconv import (
        fused_sepconv, plan, sepconv_reference)
    assert plan(16, 32, 1536, f, stride).tile_rows == 4
    x, args = _sep_args((2, 16, 32, 1536, f, stride, True), torch.bfloat16,
                        dev, seed=21)
    got = fused_sepconv(x, *args, strides=stride)
    alone = fused_sepconv(x[:1].contiguous(), *args, strides=stride)
    ref = sepconv_reference(x, *args, strides=stride)
    torch.cuda.synchronize()
    atol, rtol = TOL[torch.bfloat16]
    diff = (got.float() - ref.float()).abs()
    assert bool((diff <= atol + rtol * ref.float().abs()).all()), \
        float(diff.max())
    assert torch.equal(alone, got[:1])


# -- batch invariance and the Xception engine ------------------------------

@pytest.mark.parametrize("name,hw", [("segformer_b0", (512, 512)),
                                     ("segformer_b0_q", (512, 512)),
                                     ("deeplab_xception_fs", (512, 1024)),
                                     ("enet_fused", (256, 512)),
                                     ("deeplab", (512, 1024)),
                                     ("deeplab_q", (512, 1024)),
                                     ("unet", (256, 512)),
                                     ("unet_ph", (256, 512)),
                                     ("segformer_b0_hc_q", (512, 512)),
                                     ("segformer_b1_int8", (512, 512)),
                                     ("xception_int8", (512, 1024))])
def test_frame_alone_equals_frame_in_a_batch(dev, name, hw):
    """bf16 on the card: frame 0's logits alone and inside a batch of 4
    are bit-equal, and so are the Pipeline's grids (SegFormer's and UNet's
    backbones frame by frame, ENet's and both DeepLabs' whole-batch)."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    frames = np.stack([f for f, _, _ in synthetic.video(
        seed=0, num_frames=4, shape=(480, 640))])
    cfg = port.ModelConfig(name=name, input_width=hw[1], input_height=hw[0])
    eng = port.build_engine(name, cfg, device="cuda")
    alone = eng.logits(frames[0])
    batch = eng.logits(frames)
    assert torch.equal(alone, batch[0])
    pipe = port.Pipeline(eng, toy_calibration(hw), port.GridConfig(8.0, 8.0,
                                                                   0.1))
    single = np.stack([pipe(f).cpu().numpy() for f in frames])
    np.testing.assert_array_equal(pipe.run_batch(frames).cpu().numpy(),
                                  single)
    np.testing.assert_array_equal(
        np.stack(list(pipe.stream(iter(frames), depth=2))), single)


def test_bottleneck_bits_are_the_chain_on_frames_4_to_7(dev):
    """The bf16 kernel on ENet's trunk activations of frames 4-7 (a seeded
    engine, each block fed the plain version's output of the block
    before, as chip_smoke.py's gate does): bit for bit
    ``fused_bottleneck_chain``."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.models import \
        preprocess as pre
    from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import \
        fused_bottleneck_chain
    frames = [f for f, _, _ in synthetic.video(seed=0, num_frames=8,
                                               shape=(480, 640))]
    eng = port.build_engine("enet_fused", variables=random_enet_variables(0),
                            device="cuda")
    with torch.no_grad():
        x = pre.preprocess_for_config(torch.as_tensor(np.stack(
            frames[4:8])).cuda(), eng.cfg)
        x = eng.module.encode(x)[0].permute(0, 2, 3, 1).contiguous()
        for blk in eng.forward_fn.blocks:
            args = (blk.wp, blk.s1, blk.b1, blk.a1, blk.wcore(), blk.s2,
                    blk.b2, blk.a2, blk.we, blk.s3, blk.b3, blk.ao)
            kw = dict(kind=blk.kind, dilation=blk.dilation)
            got = blk(x)
            want = fused_bottleneck_chain(x, *args, **kw)
            assert torch.equal(got.view(torch.int16),
                               want.view(torch.int16)), (blk.kind,
                                                         blk.dilation)
            x = fused_bottleneck_ref(x, *args, **kw)


def test_rig_stitch_is_the_per_camera_max_on_card(dev):
    """bf16 on the card: the 4-camera rig on enet_fused_w16 (the kernel at
    N = 4) stitches exactly the max of the per-camera Pipeline grids."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    frames = np.stack([f for f, _, _ in synthetic.video(
        seed=0, num_frames=4, shape=(480, 640))])
    eng = port.build_engine("enet_fused_w16", device="cuda")
    cals = [toy_calibration((256, 512), yaw=y) for y in (-0.6, -0.2, 0.2,
                                                         0.6)]
    grid = port.GridConfig(8.0, 8.0, 0.1)
    for interp in ("cv2_linear", "native"):
        rig = port.MultiCameraPipeline(eng, cals, grid, interpolation=interp)
        per_cam = np.stack([port.Pipeline(eng, c, grid, interpolation=interp)(
            frames[i]).cpu().numpy() for i, c in enumerate(cals)])
        np.testing.assert_array_equal(rig(frames).cpu().numpy(),
                                      per_cam.max(0))


def test_xception_engine_on_card_matches_plain(dev):
    """deeplab_xception_fs at 512x256 on the card against the same weights
    without the kernel: float32 logits within 1e-3 (TF32 off), bf16
    labels agree on >= 0.98 of pixels; 55 launches per backbone forward
    (one forward for the two frames: Xception batches)."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.convert.flax_xception import \
        random_xception_variables
    variables = random_xception_variables(0)
    frames = np.stack([f for f, _, _ in synthetic.video(
        seed=0, num_frames=2, shape=(480, 640))])
    for dtype in ("float32", "bfloat16"):
        cfg = port.ModelConfig(name="deeplab_xception", input_width=512,
                               input_height=256, dtype=dtype)
        fused = port.build_engine("deeplab_xception_fs", cfg,
                                  variables=variables, device="cuda")
        plain = port.build_engine("deeplab_xception", cfg,
                                  variables=variables, device="cuda")
        before = kcuda.LAUNCHES["fused_sepconv"]
        got = fused.logits(frames)
        forwards = 2 if fused.frame_by_frame else 1
        assert kcuda.LAUNCHES["fused_sepconv"] - before == 55 * forwards
        ref = plain.logits(frames)
        assert kcuda.LAUNCHES["fused_sepconv"] - before == 55 * forwards
        assert bool(torch.isfinite(got).all())
        if dtype == "float32":
            assert float((got - ref).abs().max()) <= 1e-3
        else:
            agree = float((got.argmax(-1) == ref.argmax(-1)).float().mean())
            assert agree >= 0.98, agree


# -- the Mosaic probes' kernels ---------------------------------------------
#
# Copies and one add: the kernel must equal the plain version bit for bit.

PROBE_SHAPES = [(16, 64, 128), (5, 7, 3), (3, 5, 8), (17, 33, 20),
                (1, 1, 2), (64, 128, 256)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PROBE_SHAPES,
                         ids=["x".join(map(str, s)) for s in PROBE_SHAPES])
def test_probe_kernels_match_plain(dev, shape, dtype):
    from bugcar_image_segmentation_tpu_torch.ops.cuda import probes
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(shape)
                        .astype(np.float32), device=dev).to(dtype)
    key = probes.launch_key(x)
    for sr, sw in probes.STRIDES:
        before = kcuda.LAUNCHES[key]
        got = probes.strided_gather(x, sr, sw)
        torch.cuda.synchronize()
        assert kcuda.LAUNCHES[key] == before + 1
        assert torch.equal(got, probes.strided_gather_reference(x, sr, sw))
    before = kcuda.LAUNCHES["halo_add"]
    got = probes.halo_add(x)
    torch.cuda.synchronize()
    assert kcuda.LAUNCHES["halo_add"] == before + 1
    assert torch.equal(got, probes.halo_add_reference(x))


@pytest.mark.parametrize("bad", ["noncontig", "half", "2d", "stride"])
def test_probe_wrappers_reject(dev, bad):
    from bugcar_image_segmentation_tpu_torch.ops.cuda import probes
    x = torch.zeros((8, 16, 32), device=dev)
    sr = 2
    if bad == "noncontig":
        x = x.transpose(0, 1)
    elif bad == "half":
        x = x.half()
    elif bad == "2d":
        x = x[0]
    else:
        sr = 3
    with pytest.raises(ValueError):
        probes.strided_gather(x, sr, 1)
    if bad != "stride":
        with pytest.raises(ValueError):
            probes.halo_add(x)


def test_probe_script_on_card(dev):
    """scripts/torch_probe_strided.py's probes, through the kernels: all
    nine OK, four f32 gathers, four bf16 gathers and one halo add."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
    import torch_probe_strided as script
    kcuda.reset_launches()
    results = script.run_probes(dev)
    assert [ok for _, ok in results] == [True] * 9, results
    assert {k: kcuda.LAUNCHES[k] for k in ("strided_gather",
                                           "strided_gather_bf16",
                                           "halo_add")} == {
        "strided_gather": 4, "strided_gather_bf16": 4, "halo_add": 1}


# -- bench.py's path ----------------------------------------------------------

def test_bench_path_i420_against_bgr_on_card(dev):
    """``enet_w16`` at 512x256 from 640x480 frames with ``host_resize``:
    the i420 transport's grids equal the bgr transport's fed the I420
    round trip of the same resized frames (the device conversion is the
    only difference, and it equals the CPU's), in bf16 on the card; the
    i420 path's labels on the card agree with a float32 CPU run of the
    port on >= 0.999 of the pixels (TF32 off); and
    ``stream(transfer_batch=4)`` over 10 frames equals the per-frame
    grids."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import synthetic
    from bugcar_image_segmentation_tpu_torch.calibration import \
        toy_calibration
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        random_enet_variables
    from bugcar_image_segmentation_tpu_torch.ops import yuv
    from bugcar_image_segmentation_tpu_torch.ops.host_resize import \
        resize_linear
    variables = random_enet_variables(0)
    frames = [f for f, _, _ in synthetic.video(seed=1, num_frames=10,
                                               shape=(480, 640))]
    cal = toy_calibration((256, 512))
    grid = port.GridConfig(8.0, 8.0, 0.1)

    def pipe(dtype, device, transport):
        eng = port.build_engine("enet_w16", port.ModelConfig(dtype=dtype),
                                variables=variables, device=device)
        return port.Pipeline(eng, cal, grid, host_resize=True,
                             transport=transport)

    i420 = pipe("bfloat16", dev, "i420")
    bgr = pipe("bfloat16", dev, "bgr")
    got = np.stack([i420(f).cpu().numpy() for f in frames])
    round_trip = [yuv.i420_to_bgr(torch.as_tensor(yuv.bgr_to_i420_host(
        resize_linear(f, (256, 512)))), (256, 512)).numpy() for f in frames]
    np.testing.assert_array_equal(
        got, np.stack([bgr(f).cpu().numpy() for f in round_trip]))
    np.testing.assert_array_equal(
        got, np.stack(list(i420.stream(iter(frames), depth=16,
                                       sync_chunk=16, transfer_batch=4))))
    card32 = pipe("float32", dev, "i420")
    cpu32 = pipe("float32", "cpu", "i420")
    agree = np.mean([
        float((card32.segment_and_grid(f)[1].cpu()
               == cpu32.segment_and_grid(f)[1]).float().mean())
        for f in frames[:2]])
    assert agree >= 0.999, agree      # chip_smoke.py's AGREE_F32


# -- the int8 product and the fusion's torch backend -----------------------

@pytest.mark.parametrize("m", [1, 5, 16, 17, 24, 1000, 2048])
@pytest.mark.parametrize("k,n", [(512, 512), (728, 728), (2048, 768)])
def test_int_mm_exact_with_padded_rows(dev, m, k, n):
    """torch._int_mm on the card (A padded with zero rows below 24 rows or
    off a multiple of 8) equals the int32 plain version bit for bit."""
    from bugcar_image_segmentation_tpu_torch.ops import quant
    rng = np.random.default_rng(m + k + n)
    a = torch.as_tensor(rng.integers(-127, 128, (m, k), np.int8))
    b = torch.as_tensor(rng.integers(-127, 128, (n, k), np.int8)).t()
    got = quant.int8_mm(a.to(dev), b.to(dev))
    assert got.dtype == torch.int32 and got.shape == (m, n)
    assert torch.equal(got.cpu(), quant.int8_mm_reference(a, b))
    # a row-major B is accepted too (the wrapper lays it out)
    assert torch.equal(quant.int8_mm(a.to(dev), b.contiguous().to(dev)),
                       got)
    with pytest.raises(ValueError, match="multiples of 8"):
        quant.int8_mm(a[:, :k - 4].to(dev), b[:k - 4].to(dev))


def test_fusion_torch_backend_on_card(dev):
    """TemporalGridFusion(backend="torch") on the card over a 20-frame
    sequence with motion: fused grids and odds equal the numpy backend's
    bit for bit."""
    import bugcar_image_segmentation_tpu_torch as port
    rng = np.random.default_rng(7)
    a = port.TemporalGridFusion((80, 80), backend="torch", cell_m=0.1,
                                device=dev)
    b = port.TemporalGridFusion((80, 80), cell_m=0.1)
    for _ in range(20):
        g = rng.choice(np.array([-1, 0, 100], np.int8), (80, 80),
                       p=[0.2, 0.6, 0.2])
        m = (float(rng.uniform(0, 0.25)), float(rng.uniform(-0.15, 0.15)))
        got = a.update(torch.as_tensor(g, device=dev), motion_m=m)
        assert got.device.type == "cuda"
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      b.update(g, motion_m=m))
    np.testing.assert_array_equal(a.state.odds.cpu().numpy(), b._odds)


def _train_batch(hw, n, seed, dev):
    from bugcar_image_segmentation_tpu_torch import synthetic
    pairs = [synthetic.road_scene(np.random.default_rng(seed + i), hw)
             for i in range(n)]
    frames = torch.as_tensor(np.stack([f for f, _ in pairs]), device=dev)
    labels = torch.as_tensor(np.stack([lb for _, lb in pairs])
                             .astype(np.int64), device=dev)
    return frames, labels


@pytest.mark.parametrize("name", ["enet", "segformer"])
def test_train_steps_on_card_descend(dev, name):
    """bf16 steps over f32 master weights: finite losses, a lower loss on
    the batch after, master weights still f32, and no kernel launched
    (SegFormer trains through the plain attention)."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.models.enet import ENet
    from bugcar_image_segmentation_tpu_torch.models.segformer import \
        SegFormer
    from bugcar_image_segmentation_tpu_torch.training import (
        AdamW, create_train_state, make_train_step, softmax_cross_entropy)
    hw = (64, 128)
    model = ENet(15) if name == "enet" else SegFormer.preset("b0")
    model.compute_dtype = torch.bfloat16
    state = create_train_state(model, (1,) + hw + (3,),
                               optimizer=AdamW(1e-3), device="cuda")
    frames, labels = _train_batch(hw, 4, 0, dev)
    x = pre.preprocess_for_config(frames, port.ModelConfig(
        input_width=hw[1], input_height=hw[0]))
    step = make_train_step(model)
    gen = torch.Generator().manual_seed(0)
    kcuda.reset_launches()
    losses = []
    for _ in range(8):
        state, loss = step(state, x, labels, gen)
        losses.append(float(loss))
    assert not any(kcuda.LAUNCHES.values())
    assert all(np.isfinite(losses)) and losses[-1] < losses[0], losses
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        assert float(softmax_cross_entropy(model(x), labels)) < losses[0]


def test_train_step_f32_card_matches_cpu(dev):
    """One f32 ENet step (TF32 off) on the card and on the CPU from the
    same weights, batch and masks: loss 1e-4 relative, each gradient leaf
    within 2e-2 relative L2 (ENet's kinks; chip_smoke.py's TRAIN_F32)."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.models.enet import ENet
    from bugcar_image_segmentation_tpu_torch.training import (
        create_train_state, make_train_step)
    hw = (64, 128)
    frames, labels = _train_batch(hw, 2, 5, torch.device("cpu"))
    x = pre.preprocess_for_config(frames, port.ModelConfig(
        input_width=hw[1], input_height=hw[0], dtype="float32"))
    out = {}
    for where in ("cuda", "cpu"):
        model = ENet(15)
        state = create_train_state(model, (1,) + hw + (3,), device=where)
        masks = model.dropout_masks(torch.Generator().manual_seed(1), 2)
        state, loss = make_train_step(model)(
            state, x.to(where), labels.to(where), dropout=masks)
        out[where] = (float(loss), {k: p.grad.cpu() for k, p in
                                    model.named_parameters()})
    (lc, gc), (lh, gh) = out["cuda"], out["cpu"]
    assert abs(lc - lh) <= 1e-4 * abs(lh)
    for k, g in gh.items():
        assert float((gc[k] - g).norm() / g.norm().clamp_min(1e-30)) <= \
            2e-2, k


def test_dp_step_on_one_nccl_rank_equals_plain(dev):
    """The data-parallel step on a one-rank NCCL group, bf16, with cuDNN's
    deterministic algorithms, equals the plain step bit for bit."""
    import socket

    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch.models import preprocess as pre
    from bugcar_image_segmentation_tpu_torch.models.enet import ENet
    from bugcar_image_segmentation_tpu_torch.parallel import make_mesh
    from bugcar_image_segmentation_tpu_torch.training import (
        create_train_state, make_train_step)
    hw = (64, 128)
    frames, labels = _train_batch(hw, 2, 9, dev)
    x = pre.preprocess_for_config(frames, port.ModelConfig(
        input_width=hw[1], input_height=hw[0]))
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        free = sock.getsockname()[1]
    mesh = make_mesh(1, device="cuda", init_method=f"tcp://localhost:{free}",
                     rank=0, timeout_s=60)
    torch.backends.cudnn.deterministic = True
    try:
        out = []
        for m in (None, mesh):
            model = ENet(15)
            model.compute_dtype = torch.bfloat16
            state = create_train_state(model, (1,) + hw + (3,),
                                       device="cuda")
            state, loss = make_train_step(model, mesh=m)(
                state, x, labels, torch.Generator().manual_seed(0))
            out.append((loss, model.state_dict()))
    finally:
        torch.backends.cudnn.deterministic = False
        mesh.close()
    assert torch.equal(out[0][0], out[1][0])
    for k, v in out[0][1].items():
        assert torch.equal(v, out[1][1][k]), k


# -- the serving kernels as torch.library ops, and deploy artifacts ----------

def _op_case(name, dtype, dev):
    """(op, its arguments on the card, the plain version's output, its
    tolerance): the inputs of this file's kernel-vs-plain tests."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import (attention,
                                                              bottleneck,
                                                              sepconv)
    if name.startswith("fused_bottleneck"):
        kind = name.split("-")[1]
        dil = 1
        a = _args(kind, KINDS.index((kind, dil)), dev)
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (1, 32, 64, 128)).astype(np.float32), device=dev).to(dtype)
        packed = bottleneck.pack_weights(a[0], a[4], a[8], kind=kind)
        args = (x, *a[:4], bottleneck.kernel_core(a[4], kind), *a[5:],
                packed, kind, dil)
        want = bottleneck.fused_bottleneck_ref(x, *a, kind=kind,
                                               dilation=dil)
        return (torch.ops.bugcar.fused_bottleneck.default, args, want,
                TOL[dtype])
    if name.startswith("flash_attention"):
        q, k, v = _qkv((2, 3, 1000, 77, 64), dtype, dev)
        if name == "flash_attention_t":
            q, k, v = (t.transpose(-1, -2).contiguous() for t in (q, k, v))
            want = attention.attention_reference_t(q, k, v)
        else:
            want = attention.attention_reference(q, k, v)
        return (getattr(torch.ops.bugcar, name).default, (q, k, v), want,
                ATTN_TOL[dtype])
    shape = (2, 32, 64, 728, 728, 1, True)
    x, a = _sep_args(shape, dtype, dev)
    a[3] = a[3].to(dtype)        # the wrapper rounds wpw before the op
    want = sepconv.sepconv_reference(x, *a, strides=1, act_out=True)
    return (torch.ops.bugcar.fused_sepconv.default, (x, *a, 1, True), want,
            TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("name", ["fused_bottleneck-regular",
                                  "fused_bottleneck-asymmetric",
                                  "flash_attention", "flash_attention_t",
                                  "fused_sepconv"])
def test_library_op_cuda_matches_plain(dev, name, dtype):
    """Each op's CUDA implementation launches the kernel (counted in
    LAUNCHES inside the op) and agrees with the plain version."""
    op, args, want, (atol, rtol) = _op_case(name, dtype, dev)
    key = name.split("-")[0]
    before = kcuda.LAUNCHES[key]
    got = op(*args)
    torch.cuda.synchronize()
    assert kcuda.LAUNCHES[key] == before + 1
    assert got.shape == want.shape and got.dtype == want.dtype
    assert got.is_contiguous()
    diff = (got.float() - want.float()).abs()
    assert bool((diff <= atol + rtol * want.float().abs()).all()), \
        float(diff.max())


def test_artifact_launches_counted_on_card(dev, tmp_path):
    """An exported enet_fused engine, saved and loaded, launches the
    bottleneck kernel 16 times a forward, read from LAUNCHES, and gives
    the live engine's labels bit for bit."""
    import bugcar_image_segmentation_tpu_torch as port
    from bugcar_image_segmentation_tpu_torch import deploy
    eng = port.build_engine("enet_fused", port.ModelConfig(
        input_width=128, input_height=64))
    path = str(tmp_path / "enet.bcseg")
    deploy.export_engine_to(path, eng)
    dep = deploy.load_artifact(path)
    assert dep.meta["platforms"] == ["cuda"]
    x = np.random.default_rng(0).integers(0, 255, (3, 64, 128, 3),
                                          dtype=np.uint8)
    kcuda.reset_launches()
    got = dep(x)
    assert kcuda.LAUNCHES["fused_bottleneck"] == 16
    assert got.is_cuda and torch.equal(got, eng.predict(x))
    assert kcuda.LAUNCHES["fused_bottleneck"] == 32


@pytest.mark.parametrize("name", ["fused_bottleneck-regular",
                                  "flash_attention", "fused_sepconv"])
def test_failed_build_raises_without_fallback(dev, name, monkeypatch):
    """A build that fails raises from the op on CUDA tensors: nothing
    falls back to the plain version and nothing is counted."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build as kbuild

    def broken():
        raise RuntimeError("nvcc failed (a broken build, on purpose)")

    monkeypatch.setattr(kbuild, "_lib", None)
    monkeypatch.setattr(kbuild, "build", broken)
    op, args, _, _ = _op_case(name, torch.bfloat16, dev)
    key = name.split("-")[0]
    before = kcuda.LAUNCHES[key]
    with pytest.raises(RuntimeError, match="broken build"):
        op(*args)
    assert kcuda.LAUNCHES[key] == before
