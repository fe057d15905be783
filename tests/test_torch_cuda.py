"""The port's CUDA kernels on the card, against their plain PyTorch versions.

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
                                   (3, 17, 9)],
                         ids=["main1", "main4", "smaller-than-halo", "odd"])
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
                                 "wdevice"])
def test_wrapper_rejects(dev, bad):
    args = _args("regular", 3, dev)
    x = torch.randn(1, 8, 8, 128, device=dev)
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
        fused_bottleneck(x, *args, kind="regular")
    assert kcuda.LAUNCHES["fused_bottleneck"] == before
