"""The port's spatially partitioned serving (``parallel/spatial.py``: one
frame's rows over ranks, halos exchanged by ``parallel/halo.py``) in gloo
processes on the CPU, against the unsharded port and the JAX package's
unsharded engine and pipeline (its own sharded tests, in
tests/test_parallel.py, hold its GSPMD program equal to those).

Every model, against the JAX package's unsharded f32 engine on the same
tree and frames (SegFormer-B0 with the plain attention and the plain
head, as the JAX spatial path serves it; its ``_hc`` engine too): labels
equal (the MobileNetV2 DeepLab within its tie budget) and logits within
the port's tolerance against JAX for that model (ENet, Xception,
SegFormer: rtol = atol = 1e-4; UNet, DeepLab: 2e-4 of the logits'
largest magnitude).

Over 4 ranks: ENet in f32 at 32x64, batched and one frame, labels equal
to the unsharded port's and JAX's (the 1/8 trunk holds one row a rank);
the ``Pipeline`` grid of a spatial ENet equal to the unsharded port's and
the JAX ``Pipeline``'s.  Over 2 ranks: SegFormer-B0 at 64x64 (served
through its plain attention, held to the unsharded engine with the plain
attention; an ``_hc`` engine takes the plain head), UNet at 32x64 and
Xception-65 (two middle blocks) at 64x64 with labels and 15-class argmax
equal; the MobileNetV2 DeepLab at 64x64, whose ASPP image pool sums the
shards' rows in another order, with at most 1e-3 of its labels flipped
(measured 0).  Every model's logits within 1e-5 of their largest
magnitude (measured at most 8.9e-7, ENet: the convs of a shard and its
halo sum in other orders than the whole frame's).  Refused, with the JAX
package's messages: rows that do not divide the
axis, ``enet_fused``, ``_fs`` engines and SegFormer with
``input_height/32 % ranks``; and, stricter than JAX (GSPMD would pad), a
stage whose rows would not split evenly.  An axis of one rank (a
(2, 1) data x space mesh) splits nothing: labels are the unsharded
engine's, with no collective over the data axis.
"""

import os

import numpy as np
import pytest
import torch

import torch_gloo
from torch_gloo import one_thread  # noqa: F401

if __name__ != "__main__":
    import jax
    import jax.numpy as jnp

    from bugcar_image_segmentation_tpu.configs import (
        CalibrationConfig as JCal, GridConfig as JGrid, ModelConfig as JModel)
    from bugcar_image_segmentation_tpu.models.api import (
        Engine as JEngine, build_engine as jbuild)
    from bugcar_image_segmentation_tpu.models.xception import \
        Xception65DeepLab as JXception
    from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline

import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_deeplab import \
    random_deeplab_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import \
    random_segformer_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_unet import \
    random_unet_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_xception import \
    random_xception_variables
from bugcar_image_segmentation_tpu_torch.parallel import (
    Mesh, make_mesh, shard_engine_spatial)

GRID = (4.0, 4.0, 0.2)
LOGIT_TOL = 1e-5          # of the logits' largest magnitude
DEEPLAB_FLIPS = 1e-3      # share of labels an ASPP tie may flip
# name: (variables, (H, W), ranks)
MODELS = {
    "enet": (lambda: random_enet_variables(21), (32, 64), 4),
    "segformer_b0": (lambda: random_segformer_variables(4, "b0"), (64, 64),
                     2),
    "unet": (lambda: random_unet_variables(6), (32, 64), 2),
    "deeplab": (lambda: random_deeplab_variables(8), (64, 64), 2),
    "xception": (lambda: random_xception_variables(2, middle_blocks=2),
                 (64, 64), 2),
}
# the port's logit tolerance against JAX, per model (its own test file):
# (rtol, atol, atol relative to the logits' largest magnitude)
JAX_TOL = {"enet": (1e-4, 1e-4, False), "segformer_b0": (1e-4, 1e-4, False),
           "xception": (1e-4, 1e-4, False), "unet": (0.0, 2e-4, True),
           "deeplab": (0.0, 2e-4, True)}


def engine(name: str, device: str = "cpu"):
    """The engine ``name`` (a key of ``MODELS``, or a variant of one) on
    its model's seeded tree."""
    make, hw, _ = MODELS[next(k for k in MODELS if name.startswith(k))]
    cfg = port.ModelConfig(name=name, input_width=hw[1], input_height=hw[0],
                           dtype="float32")
    return port.build_engine(name, cfg, variables=make(), device=device)


def frames(name: str):
    hw = MODELS[name][1]
    rng = np.random.default_rng(len(name))
    return rng.integers(0, 256, (2,) + hw + (3,), np.uint8)


def worker(mesh_args: dict, folder: str, case: str) -> None:
    """One rank: every model of ``MODELS`` served over ``case`` ranks
    ("2x1": ENet on a (2, 1) data x space mesh)."""
    if case == "2x1":
        mesh = make_mesh(axes=("data", "space"), shape=(2, 1), **mesh_args)
        try:
            eng = shard_engine_spatial(engine("enet"), mesh)
            np.savez(os.path.join(folder, f"w{case}_rank{mesh.rank}.npz"),
                     enet_2x1_labels=eng.predict(frames("enet")).numpy(),
                     sharded=eng.spatial is not None,
                     space_group=torch.distributed.get_world_size(
                         mesh.group("space")))
        finally:
            mesh.close()
        return
    mesh = make_mesh(axes=("space",), **mesh_args)
    out = {}
    try:
        for name, (_, hw, world) in MODELS.items():
            if world != mesh.world_size:
                continue
            x = frames(name)
            eng = shard_engine_spatial(engine(name), mesh)
            out[f"{name}_labels"] = eng.predict(x).numpy()
            out[f"{name}_single"] = eng.predict(x[0]).numpy()
            out[f"{name}_logits"] = eng.logits(x).numpy()
            if name == "segformer_b0":
                hc = shard_engine_spatial(engine("segformer_b0_hc"), mesh)
                out[f"{name}_hc_logits"] = hc.logits(x).numpy()
            if name == "enet":
                pipe = port.Pipeline(eng, toy_calibration(hw),
                                     port.GridConfig(*GRID))
                out["enet_grid"] = pipe(x[0]).numpy()
        np.savez(os.path.join(folder, f"w{case}_rank{mesh.rank}.npz"),
                 **out)
    finally:
        mesh.close()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    folder = str(tmp_path_factory.mktemp("spatial"))
    cases = ((4, "4"), (2, "2"), (2, "2x1"))
    torch_gloo.run_ranks(__file__, folder, *cases)
    return [dict(np.load(os.path.join(folder, f"w{case}_rank{r}.npz")))
            for world, case in cases for r in range(world)]


def results(ranks, key):
    got = [r[key] for r in ranks if key in r]
    assert got, key
    return got


def unsharded(name: str):
    """The unsharded engine's (labels, one frame's labels, logits), the
    plain attention for SegFormer."""
    eng = engine(name)
    if name == "segformer_b0":
        eng.module.xla_attention = True
    x = frames(name)
    return (eng.predict(x).numpy(), eng.predict(x[0]).numpy(),
            eng.logits(x).numpy())


@pytest.mark.parametrize("name", ["enet", "unet", "xception",
                                  "segformer_b0"])
def test_spatial_labels_equal_unsharded(ranks, name):
    want, single, logits = unsharded(name)
    classes = logits.argmax(-1)
    assert len(np.unique(classes)) > 1
    for got in results(ranks, f"{name}_labels"):
        assert np.array_equal(got, want), (got != want).mean()
    for got in results(ranks, f"{name}_single"):
        assert np.array_equal(got, single)
    for got in results(ranks, f"{name}_logits"):
        assert np.array_equal(got.argmax(-1), classes)
        assert np.abs(got - logits).max() <= LOGIT_TOL * np.abs(
            logits).max()


def jax_engine(name: str):
    """The JAX package's unsharded f32 engine on ``name``'s seeded tree
    (SegFormer: its plain attention and plain head, as the JAX spatial
    path swaps in; Xception: two middle blocks)."""
    make, hw, _ = MODELS[name]
    cfg = JModel(name=name, input_width=hw[1], input_height=hw[0],
                 dtype="float32")
    v = jax.tree_util.tree_map(jnp.asarray, make())
    if name == "xception":
        return JEngine(JXception(num_classes=15, middle_blocks=2,
                                 dtype=jnp.float32), cfg, variables=v)
    eng = jbuild(name, cfg, variables=v)
    if name == "segformer_b0":
        return JEngine(eng.module.clone(xla_attention=True,
                                        head_cascade=False), cfg,
                       variables=v)
    return eng


@pytest.mark.parametrize("name", list(MODELS))
def test_spatial_labels_and_logits_match_jax(ranks, name):
    jeng = jax_engine(name)
    x = frames(name)
    want = np.asarray(jeng.predict(x))
    logits = np.asarray(jeng.logits(x))
    assert len(np.unique(logits.argmax(-1))) > 1
    rtol, atol, relative = JAX_TOL[name]
    atol *= np.abs(logits).max() if relative else 1.0
    for got in results(ranks, f"{name}_labels"):
        if name == "deeplab":
            assert (got != want).mean() <= DEEPLAB_FLIPS
        else:
            assert np.array_equal(got, want), (got != want).mean()
    keys = [f"{name}_logits"] + (["segformer_b0_hc_logits"]
                                 if name == "segformer_b0" else [])
    for key in keys:
        for got in results(ranks, key):
            np.testing.assert_allclose(got, logits, rtol=rtol, atol=atol)


def test_spatial_one_rank_axis_runs_unsharded(ranks):
    want, _, _ = unsharded("enet")
    got = results(ranks, "enet_2x1_labels")
    assert len(got) == 2
    for r in ranks:
        if "enet_2x1_labels" in r:
            assert not r["sharded"] and int(r["space_group"]) == 1
            assert np.array_equal(r["enet_2x1_labels"], want)


def test_spatial_enet_labels_and_grid_equal_jax(ranks):
    v = random_enet_variables(21)
    hw = MODELS["enet"][1]
    jeng = jbuild("enet", JModel(name="enet", input_width=hw[1],
                                 input_height=hw[0], dtype="float32"),
                  variables=jax.tree_util.tree_map(jnp.asarray, v))
    x = frames("enet")
    want = np.asarray(jeng.predict(x))
    for got in results(ranks, "enet_labels"):
        assert np.array_equal(got, want)
    cal = toy_calibration(hw)
    jgrid = np.asarray(JPipeline(jeng, JCal.from_reference_dict(
        cal.to_reference_dict()), JGrid(*GRID))(x[0]))
    grid = port.Pipeline(engine("enet"), cal, port.GridConfig(*GRID))(
        x[0]).numpy()
    assert np.array_equal(grid, jgrid)
    for got in results(ranks, "enet_grid"):
        assert np.array_equal(got, jgrid)


def test_spatial_segformer_hc_takes_the_plain_head(ranks):
    _, _, want = unsharded("segformer_b0")
    for got in results(ranks, "segformer_b0_hc_logits"):
        assert got.shape == want.shape
        assert np.abs(got - want).max() <= LOGIT_TOL * np.abs(want).max()


def test_spatial_deeplab_labels_within_tie_budget(ranks):
    want, _, logits = unsharded("deeplab")
    classes = logits.argmax(-1)
    assert len(np.unique(classes)) > 1
    for got in results(ranks, "deeplab_labels"):
        assert (got != want).mean() <= DEEPLAB_FLIPS
    for got in results(ranks, "deeplab_logits"):
        assert (got.argmax(-1) != classes).mean() <= DEEPLAB_FLIPS
        assert np.abs(got - logits).max() <= LOGIT_TOL * np.abs(
            logits).max()


def fake_mesh(size: int) -> Mesh:
    """A mesh object for the refusals, which come before any
    collective."""
    return Mesh(rank=0, world_size=size, device=torch.device("cpu"),
                axis_names=("space",))


@pytest.mark.parametrize("name,size,match", [
    ("enet", 3, "input height 32 does not divide the 'space' mesh axis"),
    ("enet_fused", 4, "enet_fused cannot be spatially partitioned"),
    ("xception_fs", 2, "fused-sepconv"),
    ("segformer_b0", 4, "deepest stage's rows"),
    ("unet", 4, "every stage's rows"),
])
def test_spatial_refusals(name, size, match):
    with pytest.raises(ValueError, match=match):
        shard_engine_spatial(engine(name), fake_mesh(size))


if __name__ == "__main__":
    torch_gloo.main(worker)
