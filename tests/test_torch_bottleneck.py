"""The port's fused ENet bottleneck (plain PyTorch version) against the JAX
package's Pallas kernel, run in interpret mode, and its Flax module.

Same inputs, made from a numpy seed, go through
``bugcar_image_segmentation_tpu.ops.pallas.bottleneck.fused_bottleneck``
(``interpret=True``), the Flax ``Bottleneck`` and the port's
``fused_bottleneck`` on CPU tensors (which runs ``fused_bottleneck_ref``).
Tolerance in float32: rtol = atol = 2e-4, the JAX package's own budget
for the fused bottleneck (tests/test_enet_fused.py); the measured gap is
a few 1e-6 (summation order).  The CUDA kernel itself is held against the
plain version on the card (tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.models.enet import Bottleneck as JBottleneck
from bugcar_image_segmentation_tpu.models.enet_fused import _fused
from bugcar_image_segmentation_tpu.ops.pallas.bottleneck import (
    fold_bn as jfold_bn, fused_bottleneck as jfused)
from bugcar_image_segmentation_tpu_torch.models.enet import \
    Bottleneck as TBottleneck
from bugcar_image_segmentation_tpu_torch.models.enet_fused import FusedBlock
from bugcar_image_segmentation_tpu_torch.ops import cuda as kcuda
from bugcar_image_segmentation_tpu_torch.ops.cuda.bottleneck import (
    fold_bn, fused_bottleneck, fused_bottleneck_ref)

KINDS = [("regular", 1), ("dilated", 2), ("dilated", 4), ("dilated", 8),
         ("dilated", 16), ("asymmetric", 1)]
RTOL = ATOL = 2e-4


def _inputs(kind, seed, n, h, w, c=128, mid=32):
    rng = np.random.default_rng(seed)

    def vec(k, lo, hi):
        return rng.uniform(lo, hi, k).astype(np.float32)

    def kern(*shape):
        fan = int(np.prod(shape[:-1]))
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    core = ((kern(5, 1, mid, mid), kern(1, 5, mid, mid))
            if kind == "asymmetric" else kern(3, 3, mid, mid))
    args = [kern(c, mid), vec(mid, .5, 1.5), vec(mid, -.5, .5),
            vec(mid, 0, .5), core, vec(mid, .5, 1.5), vec(mid, -.5, .5),
            vec(mid, 0, .5), kern(mid, c), vec(c, .5, 1.5), vec(c, -.5, .5),
            vec(c, 0, .5)]
    return x, args


def _to(args, fn):
    return [tuple(fn(t) for t in a) if isinstance(a, tuple) else fn(a)
            for a in args]


@pytest.mark.parametrize("shape", [(2, 16, 8), (1, 5, 6)],
                         ids=["16x8", "smaller-than-2d"])
@pytest.mark.parametrize("kind,dil", KINDS)
def test_plain_matches_pallas_interpret(kind, dil, shape):
    x, args = _inputs(kind, KINDS.index((kind, dil)), *shape)
    ref = jfused(jnp.asarray(x), *_to(args, jnp.asarray), kind=kind,
                 dilation=dil, interpret=True)
    got = fused_bottleneck(torch.from_numpy(x), *_to(args, torch.from_numpy),
                           kind=kind, dilation=dil)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def _flax_block(kind, dil, seed, h=16, w=8, c=128):
    x = np.random.default_rng(seed).standard_normal(
        (2, h, w, c)).astype(np.float32)
    mod = JBottleneck(c, kind, dilation=dil, dtype=jnp.float32)
    v = mod.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed + 1)
    # non-trivial BatchNorm statistics, so folding matters
    stats = jax.tree_util.tree_map(
        lambda a: np.asarray(a) + rng.uniform(0.0, 0.3, a.shape).astype(
            np.float32), v["batch_stats"])
    v = {"params": jax.tree_util.tree_map(np.asarray, v["params"]),
         "batch_stats": stats}
    return x, mod, v


@pytest.mark.parametrize("kind,dil", KINDS)
def test_port_module_and_fused_block_match_flax(kind, dil):
    """Flax ``Bottleneck`` → bridged port ``Bottleneck`` (plain ops) and
    its ``FusedBlock`` (the kernel's arguments + wrapper), f32."""
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        enet_state_dict

    x, mod, v = _flax_block(kind, dil, 10 + KINDS.index((kind, dil)))
    ref, _ = mod.apply(v, jnp.asarray(x), train=False)
    ref = np.asarray(ref)
    # the JAX package's own fused executor on the same tree
    wrapped = {"params": {"blk": v["params"]},
               "batch_stats": {"blk": v["batch_stats"]}}
    jgot = np.asarray(_fused(wrapped, "blk", jnp.asarray(x), kind, dil,
                             interpret=True))

    blk = TBottleneck(128, 128, kind, dilation=dil)
    blk.load_state_dict(enet_state_dict(v))
    with torch.no_grad():
        tx = torch.from_numpy(x)
        plain, _ = blk(tx.permute(0, 3, 1, 2))
        fused = FusedBlock(blk, kind, dil)(tx)
    np.testing.assert_allclose(plain.permute(0, 2, 3, 1).numpy(), ref,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fused.numpy(), ref, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(fused.numpy(), jgot, rtol=RTOL, atol=ATOL)


def test_bf16_rounding_points_track_pallas():
    """bf16: the plain version rounds where the Pallas kernel rounds (y1,
    y2; activation-dtype matmul operands), so the two agree to within a
    bf16 ulp on nearly every element (measured 3e-5 of elements differ)."""
    x, args = _inputs("regular", 3, 2, 16, 8)
    ref = np.asarray(jfused(jnp.asarray(x).astype(jnp.bfloat16),
                            *_to(args, jnp.asarray), kind="regular",
                            dilation=1, interpret=True)).astype(np.float32)
    got = fused_bottleneck(torch.from_numpy(x).bfloat16(),
                           *_to(args, torch.from_numpy), kind="regular",
                           dilation=1)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    assert (got != ref).mean() < 1e-3
    np.testing.assert_allclose(got, ref, rtol=2 ** -6, atol=2 ** -6)


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(0)
    p = {"scale": rng.uniform(.5, 1.5, 32).astype(np.float32),
         "bias": rng.uniform(-1, 1, 32).astype(np.float32)}
    s = {"mean": rng.uniform(-1, 1, 32).astype(np.float32),
         "var": rng.uniform(.1, 2, 32).astype(np.float32)}
    js, jb = jfold_bn(p, s)
    ts, tb = fold_bn({k: torch.from_numpy(a) for k, a in p.items()},
                     {k: torch.from_numpy(a) for k, a in s.items()})
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=1e-6,
                               atol=1e-7)


def test_cpu_tensors_run_the_plain_version_uncounted():
    x, args = _inputs("dilated", 4, 1, 8, 8)
    before = kcuda.LAUNCHES["fused_bottleneck"]
    a = fused_bottleneck(torch.from_numpy(x), *_to(args, torch.from_numpy),
                         kind="dilated", dilation=4)
    b = fused_bottleneck_ref(torch.from_numpy(x),
                             *_to(args, torch.from_numpy), kind="dilated",
                             dilation=4)
    assert torch.equal(a, b)
    assert kcuda.LAUNCHES["fused_bottleneck"] == before


def test_other_devices_and_kinds_raise():
    x, args = _inputs("regular", 5, 1, 4, 4)
    targs = _to(args, torch.from_numpy)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        fused_bottleneck(torch.from_numpy(x).to("meta"), *targs)
    with pytest.raises(ValueError, match="unknown bottleneck kind"):
        fused_bottleneck(torch.from_numpy(x), *targs, kind="down")


def test_kernel_sources_build_lazily():
    """Importing the wrapper builds nothing: the library is made at the
    first CUDA launch (this host has no nvcc)."""
    from bugcar_image_segmentation_tpu_torch.ops.cuda import build
    assert build._lib is None or torch.cuda.is_available()
    assert sorted(p.name for p in build.SOURCE_DIR.glob("*.cu")) == [
        "fused_bottleneck.cu"]
