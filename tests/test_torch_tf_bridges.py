"""The port's frozen-graph exporters (``convert/tf_enet.py``,
``convert/tf_xception.py``) against the JAX package's, and the graphs they
write against the port's models.

From a port model with seeded weights: the port's ``export_enet_pb`` /
``export_deeplab_pb`` and the JAX exporters fed the same weights as a
Flax tree (``flax_variables``) write the same graph -- node names, ops,
inputs and every constant, bit for bit.  The graph run as the reference
serves it (``import_graph_def`` + ``Session.run`` on its tensor names)
computes the port model's function in float32: ENet's NCHW logits within
1e-4 (the JAX package's own TF-vs-Flax budget, tests/test_tf_enet_
bridge.py), Xception's logits before the embedded ArgMax within 1e-4 of
their max and its ``SemanticPredictions`` equal to the port's argmax
wherever the port's top two logits are more than 1e-4 apart.  And
``convert_frozen_graph`` of the written file gives the model's state dict
back, bit for bit.
"""

import numpy as np
import pytest
import torch

tf = pytest.importorskip("tensorflow")

from bugcar_image_segmentation_tpu.convert import tf_enet as jtf_enet
from bugcar_image_segmentation_tpu.convert import tf_xception as jtf_xc
from bugcar_image_segmentation_tpu_torch.convert import tf_enet, tf_xception
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
    random_enet_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_tree import \
    flax_variables
from bugcar_image_segmentation_tpu_torch.convert.flax_xception import (
    random_xception_variables, xception_state_dict)
from bugcar_image_segmentation_tpu_torch.convert.tf_graphdef import (
    convert_frozen_graph, load_graphdef)
from bugcar_image_segmentation_tpu_torch.models.enet import ENet
from bugcar_image_segmentation_tpu_torch.models.xception import \
    Xception65DeepLab

ENET_HW, XC_HW, MIDDLE, XC_CLASSES = (32, 64), (64, 64), 2, 7


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def graph_signature(gd):
    """(name, op, inputs, constant bytes) of every node."""
    return [(n.name, n.op, list(n.input),
             tf.make_ndarray(n.attr["value"].tensor).tobytes()
             if n.op == "Const" else None) for n in gd.node]


def run_graph(gd, fetches, feed):
    g = tf.Graph()
    with g.as_default():
        tf.import_graph_def(gd, name="")
        with tf.compat.v1.Session(graph=g) as sess:
            return sess.run(fetches, feed)


@pytest.fixture(scope="module")
def enet(tmp_path_factory):
    from bugcar_image_segmentation_tpu_torch.convert.flax_enet import \
        enet_state_dict
    model = ENet(15)
    model.load_state_dict(enet_state_dict(random_enet_variables(6)))
    path = str(tmp_path_factory.mktemp("pb") / "enet.pb")
    gd = tf_enet.export_enet_pb(model.eval(), 15, ENET_HW, path)
    return model, gd, path


@pytest.fixture(scope="module")
def xception(tmp_path_factory):
    model = Xception65DeepLab(num_classes=XC_CLASSES, middle_blocks=MIDDLE)
    model.load_state_dict(xception_state_dict(random_xception_variables(
        7, middle_blocks=MIDDLE, num_classes=XC_CLASSES)))
    path = str(tmp_path_factory.mktemp("pb") / "deeplab.pb")
    gd = tf_xception.export_deeplab_pb(model.eval(), XC_CLASSES, XC_HW,
                                       path, middle_blocks=MIDDLE)
    return model, gd, path


def test_enet_export_is_the_jax_export(enet):
    model, gd, path = enet
    want = jtf_enet.export_enet_pb(flax_variables(model), 15, ENET_HW,
                                   path + ".jax")
    assert graph_signature(gd) == graph_signature(want)
    assert graph_signature(load_graphdef(path)) == graph_signature(gd)
    assert all(n.device == "" for n in gd.node)


def test_xception_export_is_the_jax_export(xception):
    model, gd, path = xception
    want = jtf_xc.export_deeplab_pb(flax_variables(model), XC_CLASSES,
                                    XC_HW, path + ".jax",
                                    middle_blocks=MIDDLE)
    assert graph_signature(gd) == graph_signature(want)


def test_enet_graph_computes_the_port_model(enet):
    model, gd, _ = enet
    x = np.random.default_rng(5).normal(
        size=(2,) + ENET_HW + (3,)).astype(np.float32)
    got = run_graph(gd, "CATkrIDy/concat:0",
                    {"input0:0": x.transpose(0, 3, 1, 2)})
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy().transpose(0, 3, 1, 2)
    assert got.shape == want.shape == (2, 15) + ENET_HW
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_xception_graph_computes_the_port_model(xception):
    model, gd, _ = xception
    frames = np.random.default_rng(9).integers(
        0, 256, (2,) + XC_HW + (3,), dtype=np.uint8)
    argmax = next(n for n in gd.node if n.op == "ArgMax")
    logits, preds = run_graph(gd, [argmax.input[0] + ":0",
                                   "SemanticPredictions:0"],
                              {"ImageTensor:0": frames})
    x = frames.astype(np.float32) * (2.0 / 255.0) - 1.0
    with torch.no_grad():
        want = model(torch.from_numpy(x)).numpy()
    assert logits.shape == want.shape == (2,) + XC_HW + (XC_CLASSES,)
    assert np.abs(logits - want).max() <= 1e-4 * np.abs(want).max()
    top2 = np.sort(want, -1)
    clear = top2[..., -1] - top2[..., -2] > 1e-4
    assert (preds == want.argmax(-1))[clear].all()
    assert clear.mean() > 0.99


@pytest.mark.parametrize("name", ["enet", "xception"])
def test_reload_is_exact(request, name):
    model, _, path = request.getfixturevalue(name)
    hw = ENET_HW if name == "enet" else XC_HW
    fresh = (ENet(15) if name == "enet" else Xception65DeepLab(
        num_classes=XC_CLASSES, middle_blocks=MIDDLE))
    got = convert_frozen_graph(path, fresh, np.zeros((1,) + hw + (3,)))
    want = model.state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
