"""The four serving kernels as ``torch.library`` custom ops
(``ops/cuda/library.py``), on the CPU.

``torch.library.opcheck`` checks each op's schema, its fake (shape)
implementation against its CPU implementation, and that it traces; the
fake outputs must have the plain outputs' shape, dtype and strides; the
wrappers must reach the kernels only through the ops, so that an exported
``enet_fused`` / ``xception_fs`` / SegFormer program holds the ops' nodes,
not their plain versions inlined.  The CUDA implementations are held
against the plain versions on the card in ``tests/test_torch_cuda.py``.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.ops.cuda import (attention,
                                                          bottleneck,
                                                          library, sepconv)

torch.set_num_threads(1)


def _t(rng, *shape, scale=1.0, dtype=torch.float32):
    return torch.as_tensor(rng.standard_normal(shape) * scale,
                           dtype=torch.float32).to(dtype)


def bottleneck_args(kind, dtype, seed=0, n=2, h=6, w=5):
    rng = np.random.default_rng(seed)
    c, m = bottleneck.WIDTH, bottleneck.MID
    if kind == "asymmetric":
        wcore = (_t(rng, 5, 1, m, m, scale=0.2), _t(rng, 1, 5, m, m,
                                                   scale=0.2))
    else:
        wcore = _t(rng, 3, 3, m, m, scale=0.1)
    vec = [_t(rng, k, scale=0.3).abs() + 0.5 for k in (m, m, m)]
    args = [_t(rng, n, h, w, c, dtype=dtype), _t(rng, c, m, scale=0.1),
            *vec, wcore, *[_t(rng, m, scale=0.3).abs() + 0.5
                           for _ in range(3)],
            _t(rng, m, c, scale=0.1), *[_t(rng, c, scale=0.3).abs() + 0.5
                                        for _ in range(3)]]
    return args


def op_bottleneck(kind, dtype):
    x, wp, s1, b1, a1, wcore, s2, b2, a2, we, s3, b3, ao = \
        bottleneck_args(kind, dtype)
    packed = bottleneck.pack_weights(wp, wcore, we, kind=kind)
    args = (x, wp, s1, b1, a1, bottleneck.kernel_core(wcore, kind), s2, b2,
            a2, we, s3, b3, ao, packed, kind, 2 if kind == "dilated" else 1)
    return torch.ops.bugcar.fused_bottleneck.default, args


def op_attention(name, dtype):
    rng = np.random.default_rng(1)
    if name == "flash_attention":
        shapes = [(2, 1, 24, 32), (2, 1, 10, 32), (2, 1, 10, 32)]
    else:
        shapes = [(1, 2, 32, 24), (1, 2, 32, 10), (1, 2, 32, 10)]
    q, k, v = (_t(rng, *s, dtype=dtype) for s in shapes)
    return getattr(torch.ops.bugcar, name).default, (q, k, v)


def op_sepconv(stride, dtype):
    rng = np.random.default_rng(2)
    c, f = 16, 24
    args = (_t(rng, 2, 8, 6, c, dtype=dtype), _t(rng, 3, 3, 1, c, scale=0.3),
            _t(rng, c).abs() + 0.5, _t(rng, c, scale=0.1),
            _t(rng, c, f, scale=0.2).to(dtype), _t(rng, f).abs() + 0.5,
            _t(rng, f, scale=0.1), stride, stride == 1)
    return torch.ops.bugcar.fused_sepconv.default, args


CASES = {
    **{f"bottleneck-{k}-{d}": (op_bottleneck, k, dt)
       for k in bottleneck.KINDS
       for d, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))},
    **{f"{n}-{d}": (op_attention, n, dt)
       for n in ("flash_attention", "flash_attention_t")
       for d, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))},
    **{f"sepconv-s{s}-{d}": (op_sepconv, s, dt) for s in (1, 2)
       for d, dt in (("f32", torch.float32), ("bf16", torch.bfloat16))},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_opcheck(case):
    make, *params = CASES[case]
    op, args = make(*params)
    torch.library.opcheck(op, args)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fake_matches_plain(case):
    make, *params = CASES[case]
    op, args = make(*params)
    real = op(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode:
        fake = op(*(mode.from_tensor(a) if isinstance(a, torch.Tensor)
                    else a for a in args))
    assert fake.shape == real.shape and fake.dtype == real.dtype
    assert fake.stride() == real.stride() and real.is_contiguous()


def test_wrappers_equal_plain_versions():
    """On CPU tensors each wrapper's op gives its plain version's bytes."""
    for kind in bottleneck.KINDS:
        args = bottleneck_args(kind, torch.bfloat16, seed=3)
        dil = 4 if kind == "dilated" else 1
        got = bottleneck.fused_bottleneck(*args, kind=kind, dilation=dil)
        want = bottleneck.fused_bottleneck_ref(*args, kind=kind,
                                               dilation=dil)
        assert torch.equal(got, want)
    for name, ref in (("flash_attention", attention.attention_reference),
                      ("flash_attention_t",
                       attention.attention_reference_t)):
        _, (q, k, v) = op_attention(name, torch.float32)
        assert torch.equal(getattr(attention, name)(q, k, v), ref(q, k, v))
    _, args = op_sepconv(2, torch.float32)
    assert torch.equal(sepconv.fused_sepconv(*args[:7], strides=2,
                                             act_out=False),
                       sepconv.sepconv_reference(*args[:7], strides=2,
                                                 act_out=False))


def test_kernel_core_passes_the_fused_blocks_buffer():
    core = torch.arange(10 * 32 * 32, dtype=torch.float32)
    pair = bottleneck.split_core(core, "asymmetric")
    assert bottleneck.kernel_core(pair, "asymmetric") is core
    apart = (pair[0].clone(), pair[1].clone())
    assert torch.equal(bottleneck.kernel_core(apart, "asymmetric"), core)


def test_ops_registered_once_per_process():
    """Importing the registration twice (a reload, a fresh import of the
    package's modules) reuses the ops instead of raising."""
    import importlib
    importlib.reload(library)
    for name in library.OPS:
        assert hasattr(torch.ops.bugcar, name)
    code = ("import importlib, sys\n"
            "import bugcar_image_segmentation_tpu_torch.ops.cuda.library as L\n"
            "for m in [m for m in sys.modules if 'tpu_torch.ops' in m]:\n"
            "    del sys.modules[m]\n"
            "import bugcar_image_segmentation_tpu_torch.ops.cuda.library\n"
            "print('ok')\n")
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert run.returncode == 0 and run.stdout.strip() == "ok", run.stderr


def _bugcar_nodes(exported):
    return sorted(str(n.target) for n in exported.graph.nodes
                  if n.op == "call_function" and "bugcar" in str(n.target))


def test_exported_enet_fused_holds_bottleneck_ops():
    from bugcar_image_segmentation_tpu_torch import deploy
    eng = port.build_engine("enet_fused", port.ModelConfig(
        input_width=64, input_height=32, dtype="float32"), device="cpu")
    nodes = _bugcar_nodes(deploy.export_engine(eng))
    assert nodes == ["bugcar.fused_bottleneck.default"] * 16


def test_exported_segformer_and_xception_hold_their_ops():
    from bugcar_image_segmentation_tpu_torch import deploy
    from bugcar_image_segmentation_tpu_torch.convert.flax_xception import \
        random_xception_variables
    seg = port.build_engine("segformer_b0", port.ModelConfig(
        name="segformer_b0", input_width=64, input_height=64,
        dtype="float32"), device="cpu")
    nodes = _bugcar_nodes(deploy.export_engine(seg, batch=1))
    assert nodes.count("bugcar.flash_attention.default") == 2
    assert nodes.count("bugcar.flash_attention_t.default") == 6
    v = random_xception_variables(0, num_classes=15, middle_blocks=1)
    xc = port.build_engine("xception_fs", port.ModelConfig(
        name="deeplab_xception", input_width=64, input_height=32,
        dtype="float32"), variables=v, device="cpu")
    nodes = _bugcar_nodes(deploy.export_engine(xc, batch=1))
    # 7 entry-flow sites and 3 a middle block
    assert nodes == ["bugcar.fused_sepconv.default"] * 10
