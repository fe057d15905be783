"""The port's Flax checkpoint reader (``utils/msgpack.py``,
``utils/checkpoint.py``, no msgpack or Flax) against Flax.

- The committed checkpoints read to Flax's ``msgpack_restore`` tree: the
  same keys, shapes and bytes; bfloat16 leaves (all 707 of
  ``deeplab_xception_synthetic``) come back as float32 holding the same
  values.
- The sidecar config becomes the port's ``ModelConfig``.
- The msgpack subset a Flax file can hold decodes as the msgpack package
  decodes it; what the reader does not support raises.
- The port's ENet built from the reader's tree labels synthetic road
  frames as the JAX engine built from the JAX loader does (f32, 128x64).
"""

import os

import jax
import jax.numpy as jnp
import msgpack as msgpack_pkg
import numpy as np
import pytest
from flax import serialization

from bugcar_image_segmentation_tpu.configs import ModelConfig as JModel
from bugcar_image_segmentation_tpu.models.api import build_engine as jbuild
from bugcar_image_segmentation_tpu.utils.checkpoint import \
    load_variables as jload
import bugcar_image_segmentation_tpu_torch as port
from bugcar_image_segmentation_tpu_torch import synthetic
from bugcar_image_segmentation_tpu_torch.utils import checkpoint, msgpack

CKPT_DIR = os.path.join(os.path.dirname(__file__), "..", "checkpoints")
NAMES = ["enet_synthetic", "segformer_b0_synthetic",
         "deeplab_xception_synthetic"]


def _path(name):
    return os.path.join(CKPT_DIR, f"{name}.msgpack")


def _same_tree(ours, ref):
    """Same structure; every leaf the same shape and bytes (a bf16 leaf
    of ``ref`` against its float32 widening); returns the bf16 count."""
    flat_o, tree_o = jax.tree_util.tree_flatten(ours)
    flat_r, tree_r = jax.tree_util.tree_flatten(ref)
    assert tree_o == tree_r
    bf16 = 0
    for o, r in zip(flat_o, flat_r):
        r = np.asarray(r)
        if r.dtype == jnp.bfloat16:
            bf16 += 1
            r = r.astype(np.float32)
        assert o.dtype == r.dtype and o.shape == r.shape
        assert o.tobytes() == r.tobytes()
    return bf16


@pytest.mark.parametrize("name", NAMES)
def test_reader_equals_flax_on_committed_checkpoints(name):
    with open(_path(name), "rb") as f:
        data = f.read()
    ours = msgpack.restore(data)
    bf16 = _same_tree(ours, serialization.msgpack_restore(data))
    assert bf16 == (707 if name == "deeplab_xception_synthetic" else 0)


@pytest.mark.parametrize("name", NAMES)
def test_sidecar_config(name):
    _, cfg = checkpoint.load_variables(_path(name))
    _, jcfg = jload(_path(name))
    assert isinstance(cfg, port.ModelConfig)
    assert cfg.__dict__ == jcfg.__dict__


def test_no_sidecar_gives_no_config(tmp_path):
    p = tmp_path / "tree.msgpack"
    p.write_bytes(serialization.msgpack_serialize(
        {"params": {"w": np.ones((2, 3), np.float32)}}))
    tree, cfg = checkpoint.load_variables(str(p))
    assert cfg is None
    np.testing.assert_array_equal(tree["params"]["w"], np.ones((2, 3)))


def test_subset_equals_flax_and_msgpack():
    """Every msgpack type a Flax tree can carry, in each of its widths."""
    rng = np.random.default_rng(0)
    arrays = {str(dt): rng.standard_normal((2, 3)).astype(dt)
              for dt in (np.float32, np.float64, np.float16, np.int8,
                         np.uint8, np.int32, np.int64, np.uint16)}
    arrays["bool"] = rng.random((4,)) < 0.5
    arrays["bf16"] = np.asarray(jnp.asarray(rng.standard_normal((3, 5)),
                                            jnp.bfloat16))
    arrays["empty"] = np.zeros((0, 4), np.float32)
    arrays["scalar0d"] = np.asarray(np.float32(2.5))
    tree = {"arrays": arrays,
            "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32,
                     2 ** 63 - 1, -1, -32, -33, -128, -129, -32768, -32769,
                     -2 ** 31, -2 ** 31 - 1, -2 ** 63],
            "floats": [0.5, -1e300, float("inf")],
            "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256,
                     "e" * 70000, "ünïcödé"],
            "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 70000],
            "misc": [None, True, False, [], {}],
            "big": {f"k{i}": i for i in range(20)},
            "long": list(range(70000))}
    data = serialization.msgpack_serialize(tree)
    ours = msgpack.restore(data)
    ref = serialization.msgpack_restore(data)
    _same_tree(ours["arrays"], ref["arrays"])
    plain = {k: v for k, v in ref.items() if k != "arrays"}
    plain["bins"] = [bytes(b) for b in plain["bins"]]
    got = {k: v for k, v in ours.items() if k != "arrays"}
    got["bins"] = [bytes(b) for b in got["bins"]]
    assert got == plain
    # a float32 scalar as msgpack packs it
    assert msgpack.restore(msgpack_pkg.packb(1.5, use_single_float=True)) \
        == 1.5


def test_unsupported_input_raises():
    with pytest.raises(ValueError, match="ext type 3"):
        msgpack.restore(serialization.msgpack_serialize(
            {"x": np.float32(1.0)}))
    with pytest.raises(ValueError, match="ext type 2"):
        msgpack.restore(serialization.msgpack_serialize({"x": 1 + 2j}))
    with pytest.raises(ValueError, match="chunked"):
        msgpack.restore(msgpack_pkg.packb(
            {"w": {"__msgpack_chunked_array__": True, "shape": {}}}))
    good = serialization.msgpack_serialize({"w": np.ones(3, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack.restore(good[:-3])
    with pytest.raises(ValueError, match="after the object"):
        msgpack.restore(good + b"\x00")
    with pytest.raises(ValueError, match="0xc1"):
        msgpack.restore(b"\xc1")


def test_enet_from_the_reader_labels_like_jax():
    """The trained ENet at 128x64 in f32: the port's engine from the
    reader's tree against the JAX engine from the JAX loader, on
    synthetic road frames."""
    tree, cfg = checkpoint.load_variables(_path("enet_synthetic"))
    jvars, _ = jload(_path("enet_synthetic"))
    model = dict(input_width=128, input_height=64, dtype="float32")
    jeng = jbuild("enet", JModel(**model), variables=jvars)
    eng = port.build_engine(cfg.name, port.ModelConfig(**model),
                            variables=tree, device="cpu")
    frames = np.stack([f for f, _, _ in synthetic.video(
        seed=5, num_frames=4, shape=(64, 128))])
    want = np.asarray(jeng.predict(frames))
    got = eng.predict(frames).numpy()
    np.testing.assert_array_equal(got, want)
    # the road scenes are recognised: road (1) and obstacles (2) both
    assert (got == 1).mean() > 0.05 and (got == 2).mean() > 0.05
