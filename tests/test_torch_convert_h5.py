"""The port's Keras-h5 converter (``convert/keras_h5.py``) against the JAX
package's, on h5 files written here with h5py in the layout Keras writes
(``model_weights/<layer>`` groups, ``layer_names`` / ``weight_names``
attributes), as tests/test_convert_h5.py writes them.

- ``extract_h5_ops``: the same ops, names and arrays (bit for bit) as the
  JAX reader, for conv + bias, BatchNorm, a transposed conv and a Dense.
- ``convert_keras_h5`` of a UNet written layer by layer from a seeded
  tree (convs, BatchNorms and the transposed up-convs in Keras's
  (H, W, out, in) layout): the port's state dict is the JAX pour's tree
  through ``unet_state_dict``, and the seeded weights, bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

h5py = pytest.importorskip("h5py")

from bugcar_image_segmentation_tpu.convert import keras_h5 as jh5
from bugcar_image_segmentation_tpu.models.unet import UNet as JU
from bugcar_image_segmentation_tpu_torch.convert import keras_h5
from bugcar_image_segmentation_tpu_torch.convert.flax_unet import (
    random_unet_variables, unet_state_dict)
from bugcar_image_segmentation_tpu_torch.convert.tf_graphdef import \
    param_creation_order
from bugcar_image_segmentation_tpu_torch.models.unet import UNet


def write_keras_style_h5(path, layers):
    """layers: list of (layer_name, {weight_leaf_name: array})."""
    with h5py.File(path, "w") as f:
        mw = f.create_group("model_weights")
        mw.attrs["layer_names"] = np.array(
            [name.encode() for name, _ in layers])
        for name, weights in layers:
            g = mw.create_group(name)
            wnames = [f"{name}/{leaf}:0" for leaf in weights]
            g.attrs["weight_names"] = np.array([w.encode() for w in wnames])
            for leaf, arr in weights.items():
                g.create_dataset(f"{name}/{leaf}:0", data=arr)


def test_extract_h5_ops_matches_jax(tmp_path):
    rng = np.random.default_rng(3)

    def a(*shape):
        return rng.normal(size=shape).astype(np.float32)

    layers = [
        ("conv2d_1", {"kernel": a(3, 3, 3, 4), "bias": a(4)}),
        ("batch_normalization_1", {
            "gamma": a(4), "beta": a(4), "moving_mean": a(4),
            "moving_variance": rng.uniform(0.5, 2, 4).astype(np.float32)}),
        ("conv2d_transpose_1", {"kernel": a(2, 2, 2, 4), "bias": a(2)}),
        ("depthwise_conv2d_1", {"depthwise_kernel": a(3, 3, 2, 1)}),
        ("p_re_lu_1", {"alpha": a(1, 1, 2)}),
        ("dense_1", {"kernel": a(8 * 8 * 2, 3), "bias": a(3)}),
    ]
    path = str(tmp_path / "model.h5")
    write_keras_style_h5(path, layers)
    got, want = keras_h5.extract_h5_ops(path), jh5.extract_h5_ops(path)
    assert [(o.kind, o.name) for o in got] == [(o.kind, o.name)
                                               for o in want]
    assert [o.kind for o in got] == [
        "conv", "bias", "batchnorm", "conv_transpose", "bias", "depthwise",
        "prelu", "dense", "bias"]
    for g, w in zip(got, want):
        assert sorted(g.arrays) == sorted(w.arrays)
        for k in w.arrays:
            assert np.asarray(g.arrays[k]).tobytes() == \
                np.asarray(w.arrays[k]).tobytes(), (g.name, k)


def unet_layers(tree, order):
    """Keras layers of a UNet tree, one per leaf module in creation
    order: convs (HWIO), up-convs (Keras's (H, W, out, in), mirrored),
    BatchNorms."""
    p, s = tree["params"], tree["batch_stats"]
    layers = []
    for mod in dict.fromkeys(path[:-1] for _, path in order):
        node = p
        for k in mod:
            node = node[k]
        if "scale" in node:
            st = s
            for k in mod:
                st = st[k]
            layers.append((f"batch_normalization_{len(layers)}", {
                "gamma": node["scale"], "beta": node["bias"],
                "moving_mean": st["mean"], "moving_variance": st["var"]}))
        elif mod[-1].startswith("up"):
            w = {"kernel": node["kernel"][::-1, ::-1].transpose(0, 1, 3, 2)}
            if "bias" in node:
                w["bias"] = node["bias"]
            layers.append((f"conv2d_transpose_{len(layers)}", w))
        else:
            layers.append((f"conv2d_{len(layers)}", dict(node)))
    return layers


class Jitted:
    """A Flax module whose ``init`` compiles once (the JAX converter's
    interceptor records the creations while tracing)."""

    def __init__(self, module):
        self.module = module

    def init(self, key, x, train=False):
        return jax.jit(lambda k, a: self.module.init(k, a, train=train))(
            key, x)


def test_unet_pour_matches_jax(tmp_path):
    hw = (32, 32)
    tree = random_unet_variables(8)
    _, order = param_creation_order(UNet(15), np.zeros((1,) + hw + (3,)))
    path = str(tmp_path / "unet.h5")
    write_keras_style_h5(path, unet_layers(tree, order))
    got = keras_h5.convert_keras_h5(path, UNet(15), np.zeros((1,) + hw + (3,)))
    want = jh5.convert_keras_h5(path, Jitted(JU(num_classes=15,
                                                dtype=jnp.float32)),
                                jnp.zeros((1,) + hw + (3,)))
    want = unet_state_dict(jax.tree_util.tree_map(np.asarray, want))
    seeded = unet_state_dict(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], seeded[k]), k
