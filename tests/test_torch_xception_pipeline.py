"""The port's Xception engines (``build_engine("deeplab_xception[_q][_fs]")``)
through ``Pipeline`` against the JAX package's engines and ``Pipeline``,
on the same weights and the same numpy-made frames, in float32 at 128x64:
the trained ``deeplab_xception_synthetic.msgpack`` (read with the JAX
package's loader, in this test only; its bf16 leaves taken as f32), whose
grids on synthetic road scenes hold free and occupied cells both.

Grids must be bit-equal to the JAX Pipeline's for ``__call__``,
``run_batch`` and ``stream``; ``_q`` goes through the native grid, which
reads the quarter-resolution labels (``label_scale`` 4).  The port's
``_fs`` engines run the kernel's plain version on the CPU and are held to
the same grids.  Batched runs equal per-frame runs.
"""

import os

import jax
import numpy as np
import pytest

from bugcar_image_segmentation_tpu import synthetic as jsynthetic
from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
from bugcar_image_segmentation_tpu.utils.checkpoint import load_variables
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration

GRID = (4.0, 4.0, 0.2)
HW = (64, 128)
CKPT = os.path.join(os.path.dirname(__file__), "..", "checkpoints",
                    "deeplab_xception_synthetic.msgpack")


def _cfg(dtype="float32"):
    return dict(name="deeplab_xception", input_width=HW[1],
                input_height=HW[0], dtype=dtype)


@pytest.fixture(scope="module")
def ref():
    """The JAX f32 Xception engines (full and quarter head) on the trained
    tree, and their Pipeline's grids and labels on three 320x240
    synthetic road frames (the default warp for the full head, the native
    grid for _q)."""
    variables, _ = load_variables(CKPT)
    v = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                               variables)
    frames = np.stack([f for f, _, _ in jsynthetic.video(
        seed=1, num_frames=3, shape=(240, 320))])
    cal = toy_calibration(HW)
    jcal = JCal.from_reference_dict(cal.to_reference_dict())
    out = {}
    for name, interp in (("deeplab_xception", "cv2_linear"),
                         ("deeplab_xception_q", "native")):
        jeng = jbuild(name, JModel(**_cfg()), variables=v)
        jpipe = JPipeline(jeng, jcal, JGrid(*GRID), interpolation=interp)
        out[name] = dict(
            labels=np.asarray(jeng.predict(frames)),
            grids=np.stack([np.asarray(jpipe(f)) for f in frames]),
            interp=interp, label_scale=jeng.label_scale)
    return v, frames, cal, out


@pytest.mark.parametrize("name", ["deeplab_xception", "xception_fs",
                                  "deeplab_xception_q_fs"])
def test_pipeline_grids_equal_jax(ref, name):
    v, frames, cal, out = ref
    r = out["deeplab_xception_q" if "_q" in name else "deeplab_xception"]
    eng = port.build_engine(name, port.ModelConfig(**_cfg()), variables=v,
                            device="cpu")
    assert eng.label_scale == r["label_scale"]
    assert eng.module.middle_blocks == 16
    pipe = port.Pipeline(eng, cal, port.GridConfig(*GRID),
                         interpolation=r["interp"])
    assert pipe.builder.label_scale == r["label_scale"]
    want = r["grids"]
    # the reference's grids hold free and occupied cells
    assert {0, 100} <= set(np.unique(want).tolist())
    single = np.stack([pipe(f).numpy() for f in frames])
    assert single.dtype == np.int8 and single.shape == (3, 20, 20)
    np.testing.assert_array_equal(single, want)
    np.testing.assert_array_equal(pipe.run_batch(frames).numpy(), want)
    np.testing.assert_array_equal(
        np.stack(list(pipe.stream(iter(frames), depth=2))), want)
    np.testing.assert_array_equal(eng.predict(frames[0]).numpy(),
                                  r["labels"][0])


@pytest.mark.parametrize("invariant", [True, False])
def test_batched_equals_per_frame(ref, invariant):
    """Logits of a frame alone and inside a batch, with the backbone run
    frame by frame and with the whole batch in one call (on the CPU both
    are exact)."""
    v, frames, _, _ = ref
    eng = port.build_engine("deeplab_xception_fs",
                            port.ModelConfig(**_cfg("bfloat16")),
                            variables=v, device="cpu")
    eng.frame_by_frame = invariant
    batch = eng.logits(frames).numpy()
    for i in (0, 2):
        np.testing.assert_array_equal(eng.logits(frames[i]).numpy(),
                                      batch[i])
