"""The port's checkpoint writer (``utils/msgpack.serialize``,
``utils/checkpoint.save_variables``), the inverse bridges
(``convert/flax_tree.flax_variables``) and the train-state checkpoints,
against Flax and the JAX package.

- ``serialize`` writes the bytes ``flax.serialization.msgpack_serialize``
  writes (float32, int and bfloat16 leaves, wide and deep maps), and a
  checkpoint the port writes loads bit for bit in the JAX package's
  ``load_variables`` (its sidecar too) and in the port's reader.
- Port → Flax tree → port and Flax tree → port → Flax tree are exact for
  ENet, UNet, the MobileNetV2 DeepLab and SegFormer.
- A checkpoint the port trained serves the same grids in the JAX
  ``Pipeline`` as in the port's (float32).
- ``save_train_state`` / ``restore_train_state`` resume a run: the
  restored run's next steps equal the uninterrupted run's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from bugcar_image_segmentation_tpu.configs import (CalibrationConfig as JCal,
                                                   GridConfig as JGrid,
                                                   ModelConfig as JModel)
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.pipeline import Pipeline as JPipeline
from bugcar_image_segmentation_tpu.utils.checkpoint import \
    load_variables as jload
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch.calibration import toy_calibration
from bugcar_image_segmentation_tpu_torch.convert.flax_deeplab import (
    deeplab_state_dict, random_deeplab_variables)
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import (
    enet_state_dict, random_enet_variables)
from bugcar_image_segmentation_tpu_torch.convert.flax_segformer import (
    random_segformer_variables, segformer_state_dict)
from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
    flax_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_unet import (
    random_unet_variables, unet_state_dict)
from bugcar_image_segmentation_tpu_torch.models.deeplab import DeepLabV3
from bugcar_image_segmentation_tpu_torch.models.enet import ENet
from bugcar_image_segmentation_tpu_torch.models.segformer import SegFormer
from bugcar_image_segmentation_tpu_torch.models.unet import UNet
from bugcar_image_segmentation_tpu_torch.training import (
    create_train_state, make_train_step)
from bugcar_image_segmentation_tpu_torch.utils import checkpoint, msgpack

HW = (32, 64)
GRID = (4.0, 4.0, 0.2)
# name: (port model, the bridge into it, a seeded Flax tree)
MODELS = {
    "enet": (lambda: ENet(15), enet_state_dict,
             lambda: random_enet_variables(3)),
    "unet": (lambda: UNet(15), unet_state_dict,
             lambda: random_unet_variables(3)),
    "deeplab": (lambda: DeepLabV3(15), deeplab_state_dict,
                lambda: random_deeplab_variables(3)),
    "segformer": (lambda: SegFormer.preset("b0"), segformer_state_dict,
                  lambda: random_segformer_variables(3)),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def same_bits(a, b):
    assert sorted(dict(leaves(a))) == sorted(dict(leaves(b)))
    got = dict(leaves(b))
    for k, v in leaves(a):
        v, w = np.asarray(v), np.asarray(got[k])
        assert v.shape == w.shape and v.dtype == w.dtype, k
        assert v.tobytes() == w.tobytes(), k


@pytest.fixture(scope="module")
def trained():
    """An ENet trained three steps by the port at 32x64 (f32, CPU), its
    Flax tree and config."""
    model = ENet(15)
    state = create_train_state(model, (1,) + HW + (3,), learning_rate=3e-3,
                               device="cpu")
    step = make_train_step(model)
    rng = np.random.default_rng(0)
    gen = torch.Generator().manual_seed(0)
    for _ in range(3):
        x = torch.from_numpy(rng.normal(size=(2,) + HW + (3,))
                             .astype(np.float32))
        y = torch.from_numpy(rng.integers(0, 15, (2,) + HW))
        state, _ = step(state, x, y, gen)
    cfg = port.ModelConfig(name="enet", input_width=HW[1],
                           input_height=HW[0], dtype="float32")
    return flax_variables(model), cfg


def test_serialize_writes_flax_bytes():
    rng = np.random.default_rng(1)
    tree = {"params": {f"k{i:02d}": rng.standard_normal(
        (i % 4 + 1, 3)).astype(np.float32) for i in range(20)},
        "batch_stats": {"z": {"mean": np.zeros((300,), np.float32),
                              "count": np.arange(70000, dtype=np.int32)}},
        "scalar": np.full((), 2.5, np.float32),
        "u8": np.arange(5, dtype=np.uint8)}
    assert msgpack.serialize(tree) == serialization.msgpack_serialize(tree)
    t = torch.randn(4, 9).to(torch.bfloat16)
    flax_bf16 = np.asarray(jnp.asarray(t.float().numpy(), jnp.bfloat16))
    assert msgpack.serialize({"w": t}) == serialization.msgpack_serialize(
        {"w": flax_bf16})
    for bad in ({1: np.zeros(2)}, {"x": np.float32(1.0)}, {"x": [1]}):
        with pytest.raises(ValueError):
            msgpack.serialize(bad)


def test_save_variables_loads_bit_for_bit_in_jax_and_port(trained, tmp_path):
    tree, cfg = trained
    path = str(tmp_path / "enet.msgpack")
    checkpoint.save_variables(path, tree, cfg)
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(tree)
    jtree, jcfg = jload(path)
    same_bits(tree, jtree)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert isinstance(jcfg, JModel)
    ptree, pcfg = checkpoint.load_variables(path)
    same_bits(tree, ptree)
    assert pcfg == cfg


@pytest.mark.parametrize("name", sorted(MODELS))
def test_port_to_flax_to_port_is_exact(name):
    make, to_port, _ = MODELS[name]
    model = make()
    create_train_state(model, (1, 64, 64, 3), device="cpu", seed=5)
    back = to_port(flax_variables(model))
    sd = model.state_dict()
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert torch.equal(back[k], v), k


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flax_to_port_to_flax_is_exact(name):
    make, to_port, seeded = MODELS[name]
    tree = seeded()
    model = make()
    model.load_state_dict(to_port(tree))
    same_bits(tree, flax_variables(model))


def test_port_trained_checkpoint_serves_same_grids(trained, tmp_path):
    """The JAX Pipeline on the JAX loader's tree and the port's Pipeline on
    the port's reader give the same grids for frames the trained ENet
    labels."""
    tree, cfg = trained
    path = str(tmp_path / "trained.msgpack")
    checkpoint.save_variables(path, tree, cfg)
    cal = toy_calibration(HW)
    jtree, jcfg = jload(path)
    jeng = jbuild("enet", jcfg,
                  variables=jax.tree_util.tree_map(jnp.asarray, jtree))
    jpipe = JPipeline(jeng, JCal.from_reference_dict(cal.to_reference_dict()),
                      JGrid(*GRID))
    ptree, pcfg = checkpoint.load_variables(path)
    ppipe = port.Pipeline(port.build_engine("enet", pcfg, variables=ptree,
                                            device="cpu"),
                          cal, port.GridConfig(*GRID))
    rng = np.random.default_rng(8)
    frames = [rng.integers(0, 256, (48, 96, 3), np.uint8) for _ in range(3)]
    want = np.stack([np.asarray(jpipe(f)) for f in frames])
    got = np.stack([ppipe(f).numpy() for f in frames])
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 1


def test_train_state_checkpoint_resumes(tmp_path):
    """Two steps, save, two more; against restoring the save into a fresh
    state and taking the same two steps: the same weights, moments, count
    and step."""
    rng = np.random.default_rng(2)
    batches = [(torch.from_numpy(rng.normal(size=(2, 16, 32, 3))
                                 .astype(np.float32)),
                torch.from_numpy(rng.integers(0, 3, (2, 16, 32))))
               for _ in range(4)]

    def run(state, step, lo, hi):
        for x, y in batches[lo:hi]:
            state, _ = step(state, x, y)
        return state

    model = UNet(3, widths=(8,), bottleneck_width=8)
    state = create_train_state(model, (1, 16, 32, 3), device="cpu")
    step = make_train_step(model)
    state = run(state, step, 0, 2)
    path = checkpoint.save_train_state(str(tmp_path / "ckpt"), state)
    assert path.endswith("step_2.pt")
    state = run(state, step, 2, 4)

    fresh = UNet(3, widths=(8,), bottleneck_width=8)
    restored = create_train_state(fresh, (1, 16, 32, 3), device="cpu",
                                  seed=9)
    restored = checkpoint.restore_train_state(str(tmp_path / "ckpt"),
                                              restored, 2)
    assert restored.step == 2 and restored.opt_state.count == 2
    restored = run(restored, make_train_step(fresh), 2, 4)
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    for k, v in state.opt_state.nu.items():
        assert torch.equal(v, restored.opt_state.nu[k]), k
    assert restored.step == state.step == 4
