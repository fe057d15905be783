"""The TMA route of the Mosaic probes' kernels (``csrc/strided_probes.cu``)
on the CPU: the launch plans of ``ops/cuda/probes.py`` (``tma_plan``,
``halo_plan``) run through a numpy emulation of what the kernels do with
them -- one CTA an output box, TMA loads that fill the elements outside a
tensor map with zeros, a TMA store that clips them -- held bit for bit to
the ``jax.numpy`` references that ``tests/test_torch_probes.py``
transcribes from ``scripts/probe_mosaic.py``, on the script's own input,
in float32 and bfloat16.  Also: every output element written exactly once
on ragged shapes, the route rule at the shapes the card tests run, and
TMA's limits on every plan.  The kernels themselves run only on the card
(``tests/test_torch_cuda.py``)."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_probes as ref
from bugcar_image_segmentation_tpu_torch.ops.cuda import probes

torch.set_num_threads(1)

_TORCH = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
_ITEM = {torch.float32: 4, torch.bfloat16: 2}


def _addresses(m: probes.TensorMap, item: int, coord):
    """Element offsets a box of map ``m`` at ``coord`` reads or writes,
    shaped (R, W, C) as it lands in shared memory, and which of them lie
    inside the map (TMA's bounds test, per dimension)."""
    axes = []
    for d in range(3):
        n = -(-m.box[d] // m.elem[d])
        axes.append(coord[d] + m.elem[d] * np.arange(n))
    i2, i1, i0 = np.meshgrid(axes[2], axes[1], axes[0], indexing="ij")
    inside = ((i0 >= 0) & (i0 < m.dims[0]) & (i1 >= 0) & (i1 < m.dims[1])
              & (i2 >= 0) & (i2 < m.dims[2]))
    byte = i0 * item + i1 * m.strides[0] + i2 * m.strides[1]
    assert np.all(byte % item == 0)
    return byte // item, inside


def tma_load(flat: torch.Tensor, m, coord) -> torch.Tensor:
    """One box of ``flat`` (a tensor's elements) through map ``m``: the
    elements outside the map arrive as zeros."""
    addr, inside = _addresses(m, _ITEM[flat.dtype], coord)
    assert addr[inside].min(initial=0) >= 0
    assert addr[inside].max(initial=0) < flat.numel()
    box = torch.zeros(addr.shape, dtype=flat.dtype)
    box[torch.as_tensor(inside)] = flat[torch.as_tensor(addr[inside])]
    return box


def tma_store(flat: torch.Tensor, written: np.ndarray, m, coord,
              box: torch.Tensor) -> None:
    """One box into ``flat`` through map ``m``, clipped to the map;
    ``written`` counts the writes of each element."""
    addr, inside = _addresses(m, _ITEM[flat.dtype], coord)
    assert box.shape == addr.shape
    flat[torch.as_tensor(addr[inside])] = box[torch.as_tensor(inside)]
    np.add.at(written, addr[inside], 1)


def tiles(plan: probes.Plan):
    """The output box origin (c0, w0, r0) of each CTA, as the kernels'
    ``tile_of`` decomposes blockIdx.x."""
    nc, nw, _ = plan.tiles
    bc, bw, br = plan.store.box
    for t in range(plan.grid):
        yield (t % nc) * bc, (t // nc % nw) * bw, (t // (nc * nw)) * br


def emulate_gather(x: torch.Tensor, sr: int, sw: int):
    """``strided_gather_tma`` under ``tma_plan``: (out, writes per
    element)."""
    plan = probes.tma_plan(x.shape, x.dtype, (sr, sw))
    assert plan.route == "tma", plan.reason
    out = torch.zeros(int(np.prod(plan.store.dims)), dtype=x.dtype)
    written = np.zeros(out.numel(), np.int64)
    src = x.contiguous().reshape(-1)
    for c0, w0, r0 in tiles(plan):
        box = tma_load(src, plan.load, (c0, w0 * sw, r0 * sr))
        tma_store(out, written, plan.store, (c0, w0, r0), box)
    c, wo, ro = plan.store.dims
    return out.reshape(ro, wo, c), written.reshape(ro, wo, c)


def emulate_halo(x: torch.Tensor):
    """``halo_add_tma`` under ``halo_plan``: the two shifted boxes summed
    in f32 and rounded once; (out, writes per element)."""
    plan = probes.halo_plan(x.shape, x.dtype)
    assert plan.route == "tma", plan.reason
    out = torch.zeros(x.numel(), dtype=x.dtype)
    written = np.zeros(out.numel(), np.int64)
    src = x.contiguous().reshape(-1)
    for c0, w0, r0 in tiles(plan):
        lo, hi = (tma_load(src, plan.load, (c0, w0 + dw, r0 + dr))
                  for dw, dr in probes.HALO_SHIFTS)
        tma_store(out, written, plan.store, (c0, w0, r0),
                  (lo.float() + hi.float()).to(x.dtype))
    return out.reshape(x.shape), written.reshape(x.shape)


def _probe_input(dtype):
    x = ref._jax_input().astype(dtype)
    return x, torch.as_tensor(ref._np(x)).to(_TORCH[dtype])


@pytest.mark.parametrize("probe,want,strides,dtype", ref.CASES,
                         ids=[c[0] for c in ref.CASES])
def test_gather_plan_equals_jax_reference(probe, want, strides, dtype):
    x, xt = _probe_input(dtype)
    got, written = emulate_gather(xt, *strides)
    np.testing.assert_array_equal(got.float().numpy(), ref._np(want(x)))
    assert (written == 1).all()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_halo_plan_equals_jax_reference(dtype):
    x, xt = _probe_input(dtype)
    # scripts/probe_mosaic.py:118-119
    padded = jnp.pad(x, ((1, 1), (1, 1), (0, 0)))
    want = padded[0:ref.R, 0:ref.W] + padded[2:ref.R + 2, 2:ref.W + 2]
    got, written = emulate_halo(xt)
    np.testing.assert_array_equal(got.float().numpy(), ref._np(want))
    assert (written == 1).all()


def test_probe_plans_fill_one_wave():
    """At the probes' (16, 64, 128) every plan takes TMA and spreads its
    boxes over at most one wave of the 132 SMs, with at least 64 CTAs."""
    shape = (ref.R, ref.W, ref.C)
    plans = [probes.tma_plan(shape, dt, s)
             for dt in (torch.float32, torch.bfloat16)
             for s in probes.STRIDES]
    plans += [probes.halo_plan(shape, dt)
              for dt in (torch.float32, torch.bfloat16)]
    for plan in plans:
        assert plan.route == "tma"
        assert 64 <= plan.grid <= probes.SMS, plan


RAGGED = [(17, 33, 64), (1, 1, 8), (3, 5, 8), (5, 9, 264), (300, 3, 8),
          (2, 600, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", RAGGED,
                         ids=["x".join(map(str, s)) for s in RAGGED])
def test_ragged_shapes_written_once(shape, dtype):
    """Shapes whose pixel is a multiple of 16 bytes but whose sizes are
    not multiples of the boxes: every output element is written exactly
    once and equals the plain version."""
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(shape)
                        .astype(np.float32)).to(dtype)
    for sr, sw in probes.STRIDES:
        got, written = emulate_gather(x, sr, sw)
        assert (written == 1).all(), (sr, sw)
        assert torch.equal(got, probes.strided_gather_reference(x, sr, sw))
    got, written = emulate_halo(x)
    assert (written == 1).all()
    assert torch.equal(got, probes.halo_add_reference(x))


# the card tests' shapes (tests/test_torch_cuda.py PROBE_SHAPES) and the
# route each takes in each dtype: TMA where a pixel is a multiple of 16
# bytes
CARD_ROUTES = {
    (16, 64, 128): ("tma", "tma"),
    (5, 7, 3): ("simt", "simt"),
    (3, 5, 8): ("tma", "tma"),
    (17, 33, 20): ("tma", "simt"),
    (1, 1, 2): ("simt", "simt"),
    (64, 128, 256): ("tma", "tma"),
}


@pytest.mark.parametrize("shape", list(CARD_ROUTES),
                         ids=["x".join(map(str, s)) for s in CARD_ROUTES])
def test_route_rule_at_card_shapes(shape):
    for dtype, want in zip((torch.float32, torch.bfloat16),
                           CARD_ROUTES[shape]):
        for s in probes.STRIDES:
            assert probes.tma_plan(shape, dtype, s).route == want
        assert probes.halo_plan(shape, dtype).route == want
        # an unaligned base always takes the SIMT kernels
        assert probes.tma_plan(shape, dtype, (2, 1),
                               aligned=False).route == "simt"
        assert probes.halo_plan(shape, dtype, aligned=False).reason


def _tma_limits(plan: probes.Plan, item: int) -> None:
    for m in (plan.load, plan.store):
        assert all(1 <= b <= probes.BOX_MAX for b in m.box), m
        assert all(1 <= e <= 8 for e in m.elem) and m.elem[0] == 1, m
        assert all(s % probes.TMA_ALIGN == 0 and s < 2 ** 40
                   for s in m.strides), m
        assert all(1 <= d < 2 ** 32 for d in m.dims), m
        assert (m.box[0] * item) % probes.TMA_ALIGN == 0, m
        assert m.box[1] % m.elem[1] == 0 and m.box[2] % m.elem[2] == 0
    bc, bw, br = plan.store.box
    assert bc * bw * br * item <= probes.MAX_BOX_BYTES
    assert plan.load.box == (bc, bw * plan.load.elem[1],
                             br * plan.load.elem[2])
    assert plan.tiles == tuple(-(-d // b) for d, b in
                               zip(plan.store.dims, plan.store.box))
    assert plan.grid == np.prod(plan.tiles)
    packed = list(plan.packed())
    assert len(packed) == 23 and packed[-1] == plan.grid


SWEEP = list(itertools.product((1, 2, 7, 16, 33, 257, 1000),
                               (1, 3, 64, 129, 600), (8, 16, 24, 128, 264,
                                                      1024)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_every_tma_plan_within_limits(dtype):
    item = _ITEM[dtype]
    n = 0
    for r, w, c in SWEEP:
        for plan in ([probes.tma_plan((r, w, c), dtype, s)
                      for s in probes.STRIDES]
                     + [probes.halo_plan((r, w, c), dtype)]):
            if (c * item) % 16:
                assert plan.route == "simt" and "16" in plan.reason
                continue
            assert plan.route == "tma"
            _tma_limits(plan, item)
            n += 1
    assert n > 100
