"""The port's SegFormer ``_int8`` (``quant``) and ``_hc``
(``head_cascade``) against the JAX package's default SegFormer (the
transposed stages and folded head that its ``build_engine`` builds,
Pallas attention in interpret mode), on the same weights and the same
numpy-made inputs, float32.

A narrow model, widths (32, 64, 128, 512), one block a stage, heads
(1, 2, 4, 8), decoder 512, at 64x64, makes every gate fire both ways:
stage 3's q, k, v, proj, fc1 and fc2 (K, N >= 512) and the folded
``linear_c3`` (C = 512, decoder 512) take the int8 path, the other
stages' Denses and folded products stay in float.

- ``_hc`` alone: logits within 2e-4 * max|y| (the JAX package's budget
  between its two layouts; measured 1.2e-6 relative);
- ``_int8``: the int8 products are exact, but the f32 values that are
  quantized differ between the two programs by a few ulps (other
  summation orders), and a value within that of a rounding boundary flips
  one int8 step: measured 1 flip in 4096 at stage 3's first Dense, logits
  within 0.0051 (``_int8``) / 0.0046 (``_int8_hc``) * max|y|; pinned at
  0.01 * max|y|;
- grids (the 3-class labels through the port's grid builder, whose grids
  equal the JAX builder's, tests/test_torch_grid.py) bit-equal, and the
  engines' ``Pipeline`` grids bit-equal to the JAX ``Pipeline``'s.

On the trained checkpoint (``segformer_b0_synthetic``, its own 512x256,
bf16, the JAX test's frames): the port's ``_hc`` labels against its plain
engine flip on at most 0.005 of the pixels (the JAX package's own budget,
tests/test_models.py; measured 5.3e-5), and agree with the JAX ``_hc``
engine on >= 0.999 (measured 0.99998).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import synthetic as jsynthetic
from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.models.segformer import SegFormer as JSF
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
from bugcar_image_segmentation_tpu.utils.checkpoint import load_variables
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import (
    random_segformer_variables, segformer_state_dict)
from bugcar_image_segmentation_tpu_torch.models import remap
from bugcar_image_segmentation_tpu_torch.models.segformer import (Dense,
                                                                  SegFormer)

NARROW = dict(num_classes=15, widths=(32, 64, 128, 512), depths=(1, 1, 1, 1),
              num_heads=(1, 2, 4, 8), decoder_dim=512)
# (quant, head_cascade) → the logit budget, a share of max|y|
VARIANTS = {(True, False): 0.01, (False, True): 2e-4, (True, True): 0.01}
GRID = (4.0, 4.0, 0.2)
HW = (64, 64)
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "segformer_b0_synthetic.msgpack")
HC_FLIPS = 0.005          # tests/test_models.py, trained weights
CKPT_AGREE = 0.999


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _grids(logits):
    """3-class labels of (N, H, W, C) f32 logits → the port's grids."""
    lab = remap.logits_to_drivability(torch.as_tensor(np.array(logits)),
                                      remap.remap_table(15))
    return port.OccupancyGridBuilder(toy_calibration(HW),
                                     port.GridConfig(*GRID),
                                     device="cpu")(lab).numpy()


@pytest.fixture(scope="module")
def narrow():
    """Seeded weights of the narrow model, a (2, 64, 64, 3) input and the
    JAX default module's logits for each variant."""
    v = random_segformer_variables(5, **NARROW)
    x = np.random.default_rng(2).standard_normal(
        (2, 64, 64, 3)).astype(np.float32)
    want = {}
    for quant, hc in VARIANTS:
        mod = JSF(dtype=jnp.float32, quant=quant, head_cascade=hc, **NARROW)
        want[quant, hc] = np.asarray(jax.jit(
            lambda vv, a: mod.apply(vv, a, train=False))(v, x))
    return v, x, want


@pytest.mark.parametrize("quant,hc", list(VARIANTS),
                         ids=["int8", "hc", "int8_hc"])
def test_narrow_matches_jax_default_module(narrow, quant, hc):
    v, x, want = narrow
    m = SegFormer(quant=quant, head_cascade=hc, **NARROW).eval()
    m.load_state_dict(segformer_state_dict(v))
    m.to_compute_dtype(torch.float32)
    with torch.no_grad():
        got = m(torch.from_numpy(x)).numpy()
    ref = want[quant, hc]
    assert got.shape == ref.shape == (2, 64, 64, 15)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=VARIANTS[quant, hc] * np.abs(ref).max())
    grids = _grids(got)
    assert grids.shape == (2, 20, 20) and len(np.unique(grids)) > 1
    np.testing.assert_array_equal(grids, _grids(ref))


def test_gates_fire_both_ways():
    """Under quant, exactly stage 3's Denses and the folded linear_c3 take
    the int8 path; _hc alone quantizes nothing; both fold the head."""
    m = SegFormer(quant=True, **NARROW)
    int8 = sorted(n for n, d in m.named_modules()
                  if isinstance(d, Dense) and d.int8)
    assert int8 == [f"stage3_block0.{p}" for p in (
        "attn.k", "attn.proj", "attn.q", "attn.v", "ffn.fc1", "ffn.fc2")]
    folded = m.folded(torch.float32)
    assert [d.int8 for d in folded] == [False, False, False, True]
    hc = SegFormer(head_cascade=True, **NARROW)
    assert hc.folded_head and not any(
        d.int8 for d in hc.modules() if isinstance(d, Dense))
    assert not any(d.int8 for d in hc.folded(torch.float32))
    assert not SegFormer(**NARROW).folded_head


def test_folded_weights_compose_linear_c_and_fuse(narrow):
    """Stage s's folded kernel is W_s @ fold_s with fold_s rows
    (3-s)*dd:(4-s)*dd of the fuse kernel (Flax's concat(parts[::-1])
    order), composed from the f32 parameters: to_compute_dtype leaves the
    fold's sources f32; new parameters drop the folded weights."""
    v = narrow[0]
    m = SegFormer(head_cascade=True, **NARROW)
    m.load_state_dict(segformer_state_dict(v))
    m.to_compute_dtype(torch.bfloat16)
    assert m.fuse.weight.dtype == m.linear_c3.weight.dtype == torch.float32
    assert m.stage3_block0.attn.q.weight.dtype == torch.bfloat16
    p = v["params"]
    fuse = p["fuse"]["kernel"][0, 0]
    for s, d in enumerate(m.folded(torch.float32)):
        fold = fuse[(3 - s) * 512:(4 - s) * 512]
        k = p[f"linear_c{s}"]["kernel"] @ fold
        np.testing.assert_allclose(d.weight.detach().numpy().T, k,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(d.bias.detach().numpy(),
                                   p[f"linear_c{s}"]["bias"] @ fold,
                                   rtol=1e-5, atol=1e-6)
    m.load_state_dict(segformer_state_dict(v))
    assert m._folded is None


@pytest.fixture(scope="module")
def engines():
    """JAX engines and Pipelines (f32, 64x64) for B0 _hc and B1 _int8 _q
    (B1's stage 3 clears the gate) on seeded trees, and their grids on
    three 96x48 frames."""
    frames = np.random.default_rng(1).integers(0, 256, (3, 48, 96, 3),
                                               np.uint8)
    cal = toy_calibration(HW)
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    out = {}
    for name, size, interp in (("segformer_b0_hc", "b0", "cv2_linear"),
                               ("segformer_int8_b1_q", "b1", "native")):
        v = random_segformer_variables(3, size)
        cfg = dict(name=name, input_width=HW[1], input_height=HW[0],
                   dtype="float32")
        jeng = jbuild(name, JModel(**cfg),
                      variables=jax.tree_util.tree_map(jnp.asarray, v))
        jpipe = JPipeline(jeng, jcal, JGrid(*GRID), interpolation=interp)
        out[name] = (v, cfg, interp,
                     np.stack([np.asarray(jpipe(f)) for f in frames]))
    return frames, cal, out


@pytest.mark.parametrize("name", ["segformer_b0_hc", "segformer_int8_b1_q"])
def test_engine_grids_equal_jax(engines, name):
    frames, cal, out = engines
    v, cfg, interp, want = out[name]
    eng = port.build_engine(name, port.ModelConfig(**cfg), variables=v,
                            device="cpu")
    assert eng.module.folded_head and eng.frame_by_frame
    pipe = port.Pipeline(eng, cal, port.GridConfig(*GRID),
                         interpolation=interp)
    single = np.stack([pipe(f).numpy() for f in frames])
    assert single.dtype == np.int8 and single.shape == (3, 20, 20)
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(pipe.run_batch(frames).numpy(), want)
    np.testing.assert_array_equal(
        np.stack(list(pipe.stream(iter(frames), depth=2))), want)


def test_trained_checkpoint_hc_budgets():
    """segformer_b0_synthetic at its 512x256, bf16, on the JAX test's two
    frames: port _hc vs port plain <= 0.005 flips; port _hc vs JAX _hc
    labels >= 0.999."""
    variables, cfg = load_variables(CKPT)
    tree = jax.tree_util.tree_map(np.asarray, variables)
    frames = np.stack([f for f, _, _ in jsynthetic.video(
        seed=11, num_frames=2, shape=(cfg.input_height, cfg.input_width))])
    kw = dict(input_width=cfg.input_width, input_height=cfg.input_height)
    jhc = jbuild("segformer_b0_hc", JModel(name="segformer_b0_hc", **kw),
                 variables=variables)
    want = np.asarray(jhc.predict(frames))
    hc = port.build_engine("segformer_b0_hc", port.ModelConfig(**kw),
                           variables=tree, device="cpu")
    plain = port.build_engine("segformer_b0", port.ModelConfig(**kw),
                              variables=tree, device="cpu")
    got = hc.predict(frames).numpy()
    flips = float((got != plain.predict(frames).numpy()).mean())
    assert flips <= HC_FLIPS, flips
    agree = float((got == want).mean())
    assert agree >= CKPT_AGREE, agree
