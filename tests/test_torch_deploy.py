"""The port's engine artifacts (``deploy.py``: ``torch.export`` programs in
the port's container) against the live port engine and the JAX package's
``jax.export`` artifacts, on the CPU; the container's format.

The engine cases of ``tests/test_deploy.py`` in the port (its spatial
cases wait for the port's ``parallel/``; the pipeline and rig cases are in
``tests/test_torch_deploy_pipeline.py``): an artifact's labels equal the
live port engine's bit for bit (the same aten ops run; the weights are a
snapshot, not folded constants), and the JAX artifact's labels within its
``TIE_BUDGET`` (5e-4: float argmax ties).  The live engine is a small f32
ENet (64x32) with JAX's initial weights through the bridge, its trunk on
the ``bugcar::fused_bottleneck`` op.  The snapshot does not follow a later
``load_variables`` or an in-place weight write; bad magic, truncated files
and JAX artifacts are refused.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bugcar_image_segmentation_tpu import deploy as jdeploy
from bugcar_image_segmentation_tpu.configs import ModelConfig as JModel
from bugcar_image_segmentation_tpu.models.api import Engine as JEngine
from bugcar_image_segmentation_tpu.models.enet import ENet as JENet
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import deploy

torch.set_num_threads(1)

TIE_BUDGET = 5e-4          # tests/test_deploy.py:43
CFG = dict(input_width=64, input_height=32, dtype="float32")


def frames(rng, n, h=32, w=64):
    return rng.integers(0, 255, (n, h, w, 3), dtype=np.uint8)


def assert_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def assert_within_ties(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    frac = np.mean(got != want)
    assert frac <= TIE_BUDGET, f"label mismatch {frac:.2%} > tie budget"


@pytest.fixture(scope="module")
def jax_engine():
    return JEngine(JENet(num_classes=15, dtype=jnp.float32), JModel(**CFG))


@pytest.fixture(scope="module")
def engine(jax_engine):
    """The port's enet_fused on the JAX engine's initial weights."""
    variables = jax.tree_util.tree_map(np.asarray, jax_engine.variables)
    return port.build_engine("enet_fused", port.ModelConfig(**CFG),
                             variables=variables, device="cpu")


@pytest.fixture(scope="module")
def artifact(engine, tmp_path_factory):
    """The engine's predict endpoint, symbolic batch, saved and loaded."""
    path = str(tmp_path_factory.mktemp("art") / "enet.bcseg")
    deploy.export_engine_to(path, engine, meta={"note": "r3"})
    return path, deploy.load_artifact(path)


@pytest.fixture(scope="module")
def jax_artifact(jax_engine, tmp_path_factory):
    path = str(tmp_path_factory.mktemp("jart") / "enet_jax.bcseg")
    jdeploy.export_engine_to(path, jax_engine)
    return path, jdeploy.load_artifact(path)


class TestEngineExport:
    def test_symbolic_batch_parity(self, engine, artifact, jax_artifact):
        rng = np.random.default_rng(0)
        _, dep = artifact
        for n in (1, 3, 5):
            x = frames(rng, n)
            got = dep(x)
            assert_equal(got, engine.predict(x))
            assert_within_ties(got, jax_artifact[1](jnp.asarray(x)))
        x1 = frames(rng, 1)[0]
        assert_equal(dep.predict(x1), engine.predict(x1))

    def test_static_batch(self, engine, tmp_path):
        rng = np.random.default_rng(1)
        path = str(tmp_path / "enet_b2.bcseg")
        deploy.export_engine_to(path, engine, batch=2)
        dep = deploy.load_artifact(path)
        x = frames(rng, 2)
        assert_equal(dep(x), engine.predict(x))
        assert dep.meta["in_avals"] == ["uint8[2, 32, 64, 3]"]
        with pytest.raises(Exception):
            dep(frames(rng, 3))

    def test_binary_endpoint(self, engine, jax_engine, tmp_path):
        rng = np.random.default_rng(2)
        path = str(tmp_path / "enet_bin.bcseg")
        deploy.export_engine_to(path, engine, fn="predict_binary")
        dep = deploy.load_artifact(path)
        x = frames(rng, 2)
        assert_equal(dep(x), engine.predict_binary(x))
        assert_within_ties(dep(x), jax_engine.predict_binary(x))
        assert dep.meta["fn"] == "predict_binary"

    def test_unknown_endpoint_rejected(self, engine):
        with pytest.raises(ValueError, match="fn must be one of"):
            deploy.export_engine(engine, fn="forward")
        with pytest.raises(ValueError, match="batch must be >= 1"):
            deploy.export_engine(engine, batch=0)

    def test_frozen_snapshot_semantics(self, jax_engine):
        """Neither a later load_variables nor an in-place weight write
        reaches an exported program, saved or not."""
        rng = np.random.default_rng(3)
        variables = jax.tree_util.tree_map(np.asarray, jax_engine.variables)
        eng = port.build_engine("enet_fused", port.ModelConfig(**CFG),
                                variables=variables, device="cpu")
        exported = deploy.export_engine(eng)
        x = frames(rng, 2)
        before = eng.predict(x)
        with torch.no_grad():       # in place: the live tensors themselves
            for t in [*eng.forward_fn.parameters(),
                      *eng.forward_fn.buffers()]:
                if t.is_floating_point():
                    t.add_(3.0 * torch.randn_like(t))
        in_place = eng.predict(x)
        assert (before != in_place).float().mean() > 0.01
        noise = np.random.default_rng(7)
        eng.load_variables(jax.tree_util.tree_map(
            lambda a: (a + 3.0 * noise.standard_normal(a.shape).astype(
                a.dtype) if np.issubdtype(a.dtype, np.floating) else a),
            variables))
        after = eng.predict(x)
        assert (before != after).float().mean() > 0.01, \
            "perturbation should have changed the live engine's labels"
        with torch.no_grad():
            assert_equal(exported.module()(torch.from_numpy(x)), before)

    def test_quarter_head_lift_exported(self):
        # the _q label lift happens inside the program: artifacts keep the
        # input-resolution output
        rng = np.random.default_rng(4)
        eng = port.build_engine("deeplab_q", port.ModelConfig(
            name="deeplab_q", num_classes=15, **CFG), device="cpu")
        program = deploy.export_engine(eng).module()
        x = frames(rng, 2)
        with torch.no_grad():
            y = program(torch.from_numpy(x))
        assert y.shape == (2, 32, 64)
        assert_equal(y, eng.predict(x))

    def test_frame_by_frame_engine_needs_a_static_batch(self, tmp_path):
        """SegFormer runs its backbone frame by frame: a symbolic batch is
        refused by name; a static one gives the live logits bit for bit."""
        rng = np.random.default_rng(5)
        eng = port.build_engine("segformer_b0", port.ModelConfig(
            name="segformer_b0", input_width=64, input_height=64,
            num_classes=15, dtype="float32"), device="cpu")
        with pytest.raises(ValueError, match="frame by frame"):
            deploy.export_engine(eng, fn="logits")
        path = str(tmp_path / "seg.bcseg")
        deploy.export_engine_to(path, eng, fn="logits", batch=2)
        dep = deploy.load_artifact(path)
        x = frames(rng, 2, 64, 64)
        assert_equal(dep(x), eng.logits(x))


class _BatchDependentEngine:
    """An engine whose program branches on the batch size, as the Xception
    DeepLab's does on the card (the depthwise convs' backend)."""
    name = "toy"
    frame_by_frame = False

    def __init__(self):
        self.cfg = port.ModelConfig(input_width=8, input_height=4)
        self.device = torch.device("cpu")
        self.forward_fn = torch.nn.Identity()

    def segment(self, frames, mode="multiclass"):
        return frames[..., 0] if frames.shape[0] <= 4 else frames[..., 1]

    forward = segment


def test_batch_dependent_program_refused_by_name():
    eng = _BatchDependentEngine()
    with pytest.raises(ValueError, match="'toy' does not export with a "
                                         "symbolic batch on cpu"):
        deploy.export_engine(eng)
    program = deploy.export_engine(eng, batch=3).module()
    x = torch.arange(3 * 4 * 8 * 3, dtype=torch.uint8).reshape(3, 4, 8, 3)
    assert torch.equal(program(x), x[..., 0])


class TestContainer:
    def test_bad_magic_rejected(self, tmp_path):
        p = tmp_path / "junk.bcseg"
        p.write_bytes(b"not an artifact")
        with pytest.raises(ValueError, match="bad magic"):
            deploy.load_artifact(str(p))

    def test_jax_artifact_rejected(self, jax_artifact):
        with pytest.raises(ValueError, match="jax.export artifact"):
            deploy.load_artifact(jax_artifact[0])

    def test_meta_roundtrip(self, artifact):
        meta = artifact[1].meta
        assert meta["note"] == "r3"
        assert meta["kind"] == "engine" and meta["engine"] == "enet_fused"
        assert meta["input_hw"] == [32, 64]
        assert meta["num_classes"] == 15
        assert meta["platforms"] == ["cpu"] and meta["nr_devices"] == 1
        assert artifact[1].nr_devices == 1
        assert any("uint8" in a for a in meta["in_avals"])
        assert meta["out_avals"][0].startswith("uint8[")

    def test_truncated_artifact_rejected(self, artifact, tmp_path):
        data = open(artifact[0], "rb").read()
        p = tmp_path / "cut.bcseg"
        p.write_bytes(data[:9])             # magic + partial length
        with pytest.raises(ValueError, match="truncated"):
            deploy.load_artifact(str(p))
        p.write_bytes(data[:14])            # header claims more than left
        with pytest.raises(ValueError, match="truncated or corrupt"):
            deploy.load_artifact(str(p))
        p.write_bytes(data[:len(data) // 2])   # the program cut
        with pytest.raises(ValueError, match="truncated or corrupt"):
            deploy.load_artifact(str(p))
