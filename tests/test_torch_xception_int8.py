"""The port's Xception ``_int8`` (``Xception65DeepLab(pw_int8=True)``, the
W8A8 pointwise 1x1s of ``ops/quant.py``) against the JAX package's
``xception_int8`` module, on the same seeded weights (two middle blocks)
and the same numpy-made frames, float32, at 64x32.

The int8 products are exact on both sides; the f32 values they quantize
differ by ulps (other summation orders), which flips a rounding now and
then, so the port is held to the JAX package's own budget for int8
against float (tests/test_quant.py): logits within 0.02 * max|y| and at
most 0.01 of the labels flipped (measured 0.0015 * max|y|, 0.00024 of
the labels).  The port's int8 engine against its float engine is held to
the same budget (measured 0.0022, 0.0017; the JAX package's pair 0.0022,
0.0020).  Under ``_int8`` no sepconv takes the fused kernel (``_fs`` is
inert, as in the JAX model), the parameter tree is the float one, and
the grammar takes the flags in any order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu.configs import ModelConfig as JModel
from bugcar_image_segmentation_tpu.models.api import Engine as JEngine
from bugcar_image_segmentation_tpu.models.xception import \
    Xception65DeepLab as JX
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.convert.flax_xception import (
    random_xception_variables, xception_state_dict)
from bugcar_image_segmentation_tpu_torch.models import xception as px
from bugcar_image_segmentation_tpu_torch.models.api import xception_variant
from bugcar_image_segmentation_tpu_torch.ops.cuda.sepconv import \
    sepconv_reference

MIDDLE = 2
HW = (32, 64)
LOGIT_REL = 0.02          # tests/test_quant.py TestXceptionInt8
FLIPS = 0.01
# the int8 sites at two middle blocks: block 3's sep1 and sep2, 3 per
# middle block, exit1's three, exit_sep0-2 (C and F >= 512)
INT8_SITES = 2 + 3 * MIDDLE + 3 + 3


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cfg(name):
    return dict(name=name, input_width=HW[1], input_height=HW[0],
                dtype="float32")


@pytest.fixture(scope="module")
def ref():
    """Seeded weights, four 64x32 frames, and the JAX float and int8
    engines' logits and labels on them."""
    v = random_xception_variables(4, middle_blocks=MIDDLE)
    frames = np.random.default_rng(6).integers(0, 256, (4,) + HW + (3,),
                                               np.uint8)
    out = {}
    for name, int8 in (("xception", False), ("xception_int8", True)):
        eng = JEngine(JX(middle_blocks=MIDDLE, dtype=jnp.float32,
                         pw_int8=int8),
                      JModel(**_cfg(name)),
                      variables=jax.tree_util.tree_map(jnp.asarray, v))
        out[name] = (np.asarray(eng.logits(frames)),
                     np.asarray(eng.predict(frames)))
    return v, frames, out


def _engine(name, v):
    return port.build_engine(name, port.ModelConfig(**_cfg(name)),
                             variables=v, device="cpu")


def _within_budget(logits, labels, ref_logits, ref_labels):
    rel = np.abs(logits - ref_logits).max() / np.abs(ref_logits).max()
    flips = float((labels != ref_labels).mean())
    assert rel < LOGIT_REL and flips <= FLIPS, (rel, flips)


@pytest.mark.parametrize("name", ["xception_int8",
                                  "deeplab_xception_fs_int8"])
def test_int8_engine_matches_jax(ref, name):
    v, frames, out = ref
    eng = _engine(name, v)
    assert eng.module.pw_int8 and eng.module.middle_blocks == MIDDLE
    logits = eng.logits(frames).numpy()
    assert logits.shape == (4, *HW, 15)
    _within_budget(logits, eng.predict(frames).numpy(),
                   *out["xception_int8"])


def test_int8_against_float_engine(ref):
    """The port's own int8 and float engines, the JAX package's budget."""
    v, frames, out = ref
    f32, i8 = _engine("xception", v), _engine("xception_int8", v)
    assert set(f32.module.state_dict()) == set(i8.module.state_dict())
    _within_budget(i8.logits(frames).numpy(), i8.predict(frames).numpy(),
                   f32.logits(frames).numpy(), f32.predict(frames).numpy())
    # and the float engine is the JAX float engine's (tests/
    # test_torch_xception.py holds it tightly)
    np.testing.assert_allclose(f32.logits(frames).numpy(),
                               out["xception"][0], rtol=1e-4, atol=1e-4)


def test_int8_sites_and_no_fused_sepconv(monkeypatch, ref):
    """Exactly the sepconvs with C, F >= 512 take the int8 pointwise; under
    _int8 the fused kernel runs nowhere, _fs or not."""
    v, frames, _ = ref
    m = px.Xception65DeepLab(middle_blocks=MIDDLE, fused_sepconv=True,
                             pw_int8=True)
    sites = [m_ for m_ in m.sepconvs() if m_.int8]
    assert len(sites) == INT8_SITES
    assert all(s.pointwise.weight.shape[:2] >= (512, 512) for s in sites)
    assert not any(s.fused for s in m.sepconvs())
    m.load_state_dict(xception_state_dict(v))
    m.eval().to_compute_dtype(torch.bfloat16)
    assert all(s.pointwise.weight.dtype == torch.float32 for s in sites)
    calls = []
    monkeypatch.setattr(px, "fused_sepconv",
                        lambda *a, **k: calls.append(1)
                        or sepconv_reference(*a, **k))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (1,) + HW + (3,)).astype(np.float32)).to(torch.bfloat16)
    with torch.no_grad():
        y = m(x)
    assert not calls and y.dtype == torch.float32
    assert bool(torch.isfinite(y).all())


def test_grammar():
    assert xception_variant("xception_int8") == (False, True, False)
    assert xception_variant("deeplab_xception_fs_int8_q") == (True, True,
                                                              True)
    assert xception_variant("xception_q") == (True, False, False)
    for name in ("xception_int4", "deeplab_xception_int8_w8"):
        with pytest.raises(ValueError, match="grammar"):
            port.build_engine(name, device="cpu")
    eng = port.build_engine("xception_int8_q_w16", device="cpu")
    assert (eng.int8, eng.label_scale, eng.weights_bf16) == (True, 4, True)
    assert (eng.cfg.input_width, eng.cfg.input_height) == (1024, 512)
