"""The arithmetic of the fused bottleneck's bf16 kernel
(``csrc/fused_bottleneck.cu``, ``fused_bottleneck_mma``), emulated in torch
on the CPU, and the wrapper's weight packing and argument checks.

The kernel runs only on the card (tests/test_torch_cuda.py and
chip_smoke.py hold it bit for bit to ``ops/cuda/bottleneck.py``'s
``fused_bottleneck_chain``).  Its arithmetic: bf16 operands and weights,
f32 sums, y1, the 5x1 result and y2 rounded to bf16, the residual and the
last PReLU in f32, every rounded value the one an f32 FMA chain over the
input channels in order (taps row by row) gives -- the chain, an FMA
emulated as the exact product plus the sum in f64, rounded to f32.
The kernel sums on the tensor cores and settles each rounding with an
error bound, recomputing by the chain where the bound cannot settle it;
``test_settle_rounds_as_the_chain`` emulates that rule (k16 step sums, E =
2^-17 A + 2^-18 Q) and checks that whatever it settles rounds as the chain.

The chain is held to the plain version (``fused_bottleneck_ref``) under
chip_smoke.py's bf16 budget, |got - ref| <= 2^-6 + 2^-5 |ref|, at every trunk
block of ``models/enet.py`` (``TRUNK``) at the path's 32x64 map and a ragged
one, and to the JAX package's Pallas kernel in interpret mode.  Where
another summation order rounds y1, the 5x1 result or y2 apart from the
chain, ``_ambiguous`` (the smoke's attribution of outputs over that budget)
flags the value.
"""

import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu_torch.models.enet import TRUNK
from bugcar_image_segmentation_tpu_torch.ops.cuda import bottleneck as bn

ATOL, RTOL = 2 ** -6, 2 ** -5      # chip_smoke.py TOL["bfloat16"]
C, MID = 128, 32
PAIRS = [(kind, dil) for _, kind, dil in TRUNK]
PAIR_IDS = [f"b{s}-{k}-{d}" for s, k, d in TRUNK]


@pytest.fixture(autouse=True)
def one_thread():
    """The emulations are long chains of small tensor ops: one intra-op
    thread each, so that they do not stall on a busy host."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(kind, seed, n, h, w):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32))

    def vec(k, lo, hi):
        return t(rng.uniform(lo, hi, k))

    def kern(*shape):
        return t(rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1])))

    core = ((kern(5, 1, MID, MID), kern(1, 5, MID, MID))
            if kind == "asymmetric" else kern(3, 3, MID, MID))
    args = [kern(C, MID), vec(MID, .5, 1.5), vec(MID, -.5, .5),
            vec(MID, 0, .5), core, vec(MID, .5, 1.5), vec(MID, -.5, .5),
            vec(MID, 0, .5), kern(MID, C), vec(C, .5, 1.5), vec(C, -.5, .5),
            vec(C, 0, .5)]
    x = t(rng.standard_normal((n, h, w, C))).bfloat16()
    return x, args


def _bf(t):
    return t.to(torch.bfloat16).float()


def _prelu(v, a):
    return torch.where(v >= 0, v, a * v)


def _split(p):
    """A rounding point as (its inputs, its weights, t: the f32 sum to the
    value before the last step, last: PReLU or nothing, whether a PReLU
    follows)."""
    last = ((lambda t: _prelu(t, p.slope)) if p.slope is not None
            else (lambda t: t))
    return (p.inputs, p.weights, p._replace(slope=None).finish, last,
            p.slope is not None)


ERR_ABS, ERR_ACC = bn.ERR_ABS, bn.ERR_ACC   # csrc/fused_bottleneck.cu kErr*


def _tc_sum(a, w):
    """The kernel's tensor-core sum of a @ w: each k16 step's dot (here
    exact, rounded to f32) added to an f32 sum; with the bound's terms A =
    |a| @ |w| and Q = the |running sum| before each step and at the end."""
    acc = torch.zeros(*a.shape[:-1], w.shape[1])
    q = torch.zeros_like(acc)
    for k0 in range(0, w.shape[0], 16):
        q = q + acc.abs()
        acc = acc + (a[..., k0:k0 + 16].double()
                     @ w[k0:k0 + 16].double()).float()
    q = q + acc.abs()
    return acc, (a.abs().double() @ w.abs().double()).float(), q


def _settle(acc, big_a, q, t, last, kink):
    """The kernel's settle rule: the bf16 bits of every f32 sum within E of
    acc, and where they are not settled (not all equal, astride t = 0 where
    an activation follows, or a zero that is not a negative one's)."""
    e = ERR_ABS * big_a + ERR_ACC * q
    tl, th = t(acc - e), t(acc + e)
    bl = last(tl).to(torch.bfloat16).view(torch.int16)
    bh = last(th).to(torch.bfloat16).view(torch.int16)
    neg = (tl < 0) & (th < 0) & kink
    unsure = (bl != bh) | (((bl & 0x7fff) == 0) & ~neg)
    if kink:
        unsure |= ~neg & ((tl < 0) | (th < 0))
    exact = e == 0
    return torch.where(exact, last(t(acc)).to(torch.bfloat16)
                       .view(torch.int16), bl), unsure & ~exact


def _over(got, ref):
    diff = (got.float() - ref.float()).abs()
    return int((diff > ATOL + RTOL * ref.float().abs()).sum()), \
        float(diff.max())


@pytest.mark.parametrize("shape", [(1, 32, 64), (2, 5, 13)],
                         ids=["main", "ragged"])
@pytest.mark.parametrize("kind,dil", PAIRS, ids=PAIR_IDS)
def test_emulation_within_budget(kind, dil, shape):
    x, args = _inputs(kind, 7 + PAIRS.index((kind, dil)), *shape)
    got = bn.fused_bottleneck_chain(x, *args, kind=kind, dilation=dil)
    ref = bn.fused_bottleneck_ref(x, *args, kind=kind, dilation=dil)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    over, err = _over(got, ref)
    assert over == 0, (over, err)


@pytest.mark.parametrize("shape", [(1, 32, 64), (2, 5, 13)],
                         ids=["main", "ragged"])
@pytest.mark.parametrize("kind,dil", PAIRS, ids=PAIR_IDS)
def test_settle_rounds_as_the_chain(kind, dil, shape):
    """At every rounding point (y1, the 5x1 result, y2, the output) an
    element the bound settles gets the chain's bits, and the bound leaves
    the chain a minority of the elements to recompute."""
    x, args = _inputs(kind, 50 + PAIRS.index((kind, dil)), *shape)
    for p in bn.chain_points(x, *args, kind=kind, dilation=dil):
        inp, w, t, last, kink = _split(p)
        want = last(t(bn._fma_chain(inp, w))).to(torch.bfloat16).view(
            torch.int16)
        bits, unsure = _settle(*_tc_sum(inp, w), t, last, kink)
        assert torch.equal(bits[~unsure], want[~unsure])
        assert float(unsure.float().mean()) < 0.3


@pytest.mark.parametrize("kind,dil", PAIRS, ids=PAIR_IDS)
def test_other_orders_round_apart_only_where_ambiguous(kind, dil):
    """The exact sums rounded once, and the chain over the inputs in reverse
    order, against the chain at every rounding point before the output:
    every value they round to other bits is one ``_ambiguous`` flags, and
    it flags a small share."""
    x, args = _inputs(kind, 90 + PAIRS.index((kind, dil)), 1, 32, 64)
    for p in bn.chain_points(x, *args, kind=kind, dilation=dil)[:-1]:
        want = _bf(p.finish(bn._fma_chain(p.inputs, p.weights)))
        flagged = bn._ambiguous(p)
        for acc in ((p.inputs.double() @ p.weights.double()).float(),
                    bn._fma_chain(p.inputs.flip(-1), p.weights.flip(0))):
            apart = _bf(p.finish(acc)) != want
            assert not bool((apart & ~flagged).any()), (p.name, int(
                (apart & ~flagged).sum()))
        assert float(flagged.float().mean()) < 0.3, p.name


@pytest.mark.parametrize("kind,dil", PAIRS, ids=PAIR_IDS)
def test_plain_rounds_apart_only_where_explained(kind, dil):
    """chip_smoke.py's attribution on the CPU's plain version: every y1, z
    or y2 it rounds apart from the chain is ambiguous or fed by one that
    differs, and every output over the budget has a y2 that differs."""
    x, args = _inputs(kind, 130 + PAIRS.index((kind, dil)), 2, 32, 64)
    moved, counts = bn.rounds_apart(x, *args, kind=kind, dilation=dil)
    assert moved.shape == x.shape[:3]
    assert all(c["unexplained"] == 0 for c in counts.values()), counts
    got = bn.fused_bottleneck_chain(x, *args, kind=kind, dilation=dil)
    ref = bn.fused_bottleneck_ref(x, *args, kind=kind, dilation=dil)
    diff = (got.float() - ref.float()).abs()
    over = diff > ATOL + RTOL * ref.float().abs()
    assert not bool((over & ~moved[..., None]).any())


@pytest.mark.parametrize("kind,dil", [("regular", 1), ("dilated", 2),
                                      ("asymmetric", 1)])
def test_emulation_matches_pallas_interpret(kind, dil):
    """The JAX package's Pallas kernel (interpret mode, bf16 x) against the
    kernel's arithmetic, under the same budget."""
    import jax.numpy as jnp

    from bugcar_image_segmentation_tpu.ops.pallas.bottleneck import \
        fused_bottleneck as jfused

    x, args = _inputs(kind, 3, 1, 8, 8)
    jargs = [tuple(jnp.asarray(t.numpy()) for t in a) if isinstance(a, tuple)
             else jnp.asarray(a.numpy()) for a in args]
    want = np.asarray(jfused(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16), *jargs, kind=kind, dilation=dil,
        interpret=True)).astype(np.float32)
    got = bn.fused_bottleneck_chain(x, *args, kind=kind, dilation=dil)
    over, err = _over(got, torch.from_numpy(want))
    assert over == 0, (over, err)


def _unfragment(frag, k, n):
    """Inverse of the fragment order, by the mma.sync B-fragment layout:
    lane 4g + t holds rows 2t, 2t + 1, 2t + 8, 2t + 9 of column g."""
    out = torch.empty(k, n, dtype=frag.dtype)
    blocks = frag.reshape(k // 16, n // 8, 32, 4)
    for kk in range(k // 16):
        for j in range(n // 8):
            for lane in range(32):
                g, t = divmod(lane, 4)
                for e, row in enumerate((2 * t, 2 * t + 1, 2 * t + 8,
                                         2 * t + 9)):
                    out[16 * kk + row, 8 * j + g] = blocks[kk, j, lane, e]
    return out


@pytest.mark.parametrize("kind", bn.KINDS)
def test_pack_weights_round_trip(kind):
    """The bf16 kernel's weights: wp, the core taps and we, one after the
    other, each back from fragment order equal to it rounded to bf16."""
    _, args = _inputs(kind, 1, 1, 1, 1)
    wp, wcore, we = args[0], args[4], args[8]
    packed = bn.pack_weights(wp, wcore, we, kind=kind)
    assert packed.dtype == torch.bfloat16 and packed.is_contiguous()
    assert packed.shape == (bn.pack_elems(kind),)
    core = (torch.cat([t.reshape(-1, MID) for t in wcore])
            if kind == "asymmetric" else wcore.reshape(-1, MID))
    parts = torch.split(packed, [wp.numel(), core.numel(), we.numel()])
    for part, want in zip(parts, (wp, core, we)):
        assert torch.equal(_unfragment(part, *want.shape), want.bfloat16())


@pytest.fixture
def cpu_seam(monkeypatch):
    """launch_args on CPU tensors: the device type it takes and its stream."""
    monkeypatch.setattr(bn, "_CARD", "cpu")
    monkeypatch.setattr(bn, "_stream", lambda dev: 0)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("kind,dil", [("dilated", 4), ("asymmetric", 1)])
def test_launch_args_marshal(cpu_seam, kind, dil, dtype):
    """The C launcher's arguments: shapes, the f32 pointers, the packed
    weights for bf16 (packed here when not given), kind, dilation, type."""
    x, args = _inputs(kind, 4, 2, 6, 10)
    x = x.to(dtype)
    out = torch.empty_like(x)
    packed = bn.pack_weights(args[0], args[4], args[8], kind=kind)
    raw, keep = bn.launch_args(x, out, *args, kind=kind, dilation=dil,
                               packed=packed)
    assert raw[:7] == (x.data_ptr(), out.data_ptr(), 2, 6, 10, C, MID)
    assert raw[7] == args[0].data_ptr() and raw[15] == args[8].data_ptr()
    bf16 = dtype == torch.bfloat16
    assert raw[19] == (packed.data_ptr() if bf16 else 0)
    assert raw[20:23] == (int(kind == "asymmetric"), dil, int(bf16))
    if bf16:   # not given: packed in the call, kept alive with the tuple
        raw2, keep2 = bn.launch_args(x, out, *args, kind=kind, dilation=dil)
        assert torch.equal(keep2[1], packed) and raw2[19] == \
            keep2[1].data_ptr()


@pytest.mark.parametrize("bad,msg", [
    ("cuda", "x must be a CUDA tensor"), ("width", "x must be (N, H, W, 128)"),
    ("half", "x must be float32 or bfloat16"),
    ("noncontig", "x must be contiguous"), ("dilation", "dilation must be"),
    ("wp_dtype", "wp must be float32"), ("wp_shape", "wp must have shape"),
    ("packed", "packed must be a contiguous bfloat16 tensor")])
def test_launch_args_refusals(monkeypatch, bad, msg):
    """Each refusal names what is wrong (the message is formatted only
    when a check fails)."""
    monkeypatch.setattr(bn, "_stream", lambda dev: 0)
    if bad != "cuda":
        monkeypatch.setattr(bn, "_CARD", "cpu")
    x, args = _inputs("regular", 5, 1, 4, 4)
    kw = {"dilation": 1}
    if bad == "width":
        x = x[..., :64].contiguous()
    elif bad == "half":
        x = x.half()
    elif bad == "noncontig":
        x = x.transpose(1, 2)
    elif bad == "dilation":
        kw["dilation"] = 0
    elif bad == "wp_dtype":
        args[0] = args[0].double()
    elif bad == "wp_shape":
        args[0] = args[0][:64]
    elif bad == "packed":
        kw["packed"] = bn.pack_weights(args[0], args[4], args[8])[:-8]
    with pytest.raises(ValueError, match=msg.replace("(", r"\(")
                       .replace(")", r"\)")):
        bn.launch_args(x, torch.empty_like(x), *args, **kw)
