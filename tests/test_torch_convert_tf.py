"""The port's frozen-graph converter (``convert/tf_graphdef.py``) against the
JAX package's, on graphs frozen here with today's TF.

- ``extract_ops``: the same ops (kind, graph name, every array bit for
  bit) as the JAX walker, for each op form tests/test_convert.py covers:
  Conv2D + BiasAdd + FusedBatchNorm, the four decomposed PReLU forms, a
  const scale Mul that is no PReLU, a DeepLab preamble with an embedded
  ArgMax, and a graph with DepthwiseConv2dNative, Conv2DBackpropInput and
  MatMul.
- ``param_creation_order``: the port's order, mapped to Flax paths, is
  the JAX converter's list for ENet, Xception-65 (two middle blocks), the
  MobileNetV2 DeepLab, UNet and SegFormer-B0.  The JAX list is recorded by
  the JAX converter's own interceptor over an abstract ``init``
  (``jax.eval_shape``: the same Python, no arithmetic).  SegFormer is held
  on its textbook lowering (``chw_stages=0, chw_head=False``), the one
  the port's module follows; the JAX package's transposed head creates
  its ``fuse`` kernel before the ``linear_c*`` it folds it into.
- ``pour_into_module`` of an ENet and an Xception graph into the port's
  modules: the state dict is the JAX pour's tree through the port's
  bridges (``enet_state_dict``, ``xception_state_dict``), bit for bit.
- Shape mismatches raise, naming the graph op and the leaf.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

tf = pytest.importorskip("tensorflow")

from bugcar_image_segmentation_tpu.convert import tf_enet as jtf_enet
from bugcar_image_segmentation_tpu.convert import tf_graphdef as jconv
from bugcar_image_segmentation_tpu.convert import tf_xception as jtf_xc
from bugcar_image_segmentation_tpu.models.deeplab import DeepLabV3 as JD
from bugcar_image_segmentation_tpu.models.enet import ENet as JENet
from bugcar_image_segmentation_tpu.models.segformer import SegFormer as JS
from bugcar_image_segmentation_tpu.models.unet import UNet as JU
from bugcar_image_segmentation_tpu.models.xception import \
    Xception65DeepLab as JX
from bugcar_image_segmentation_tpu_torch.convert import tf_graphdef as conv
from bugcar_image_segmentation_tpu_torch.convert.flax_enet import (
    enet_state_dict, random_enet_variables)
from bugcar_image_segmentation_tpu_torch.convert.flax_xception import (
    random_xception_variables, xception_state_dict)
from bugcar_image_segmentation_tpu_torch.models.deeplab import DeepLabV3
from bugcar_image_segmentation_tpu_torch.models.enet import ENet
from bugcar_image_segmentation_tpu_torch.models.layers import BatchNorm, Conv
from bugcar_image_segmentation_tpu_torch.models.segformer import SegFormer
from bugcar_image_segmentation_tpu_torch.models.unet import UNet
from bugcar_image_segmentation_tpu_torch.models.xception import \
    Xception65DeepLab


def freeze(fn, spec):
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)
    return convert_variables_to_constants_v2(
        fn.get_concrete_function(spec)).graph.as_graph_def()


def var(rng, *shape, lo=None):
    a = (rng.normal(size=shape) if lo is None
         else rng.uniform(lo, 2.0, size=shape))
    return tf.Variable(a.astype(np.float32))


def g_conv_bias_bn(rng):
    w1, b1 = var(rng, 3, 3, 3, 8), var(rng, 8)
    gamma, beta, mean = var(rng, 8), var(rng, 8), var(rng, 8)
    v, w2 = var(rng, 8, lo=0.5), var(rng, 1, 1, 8, 4)

    @tf.function
    def f(x):
        y = tf.nn.bias_add(tf.nn.conv2d(x, w1, 1, "SAME"), b1)
        y, _, _ = tf.compat.v1.nn.fused_batch_norm(
            y, gamma, beta, mean, v, epsilon=1e-3, is_training=False)
        return tf.nn.conv2d(tf.nn.relu(y), w2, 1, "SAME")
    return freeze(f, tf.TensorSpec([1, 8, 8, 3], tf.float32))


def _prelu_graph(make):
    def build(rng):
        w = var(rng, 1, 1, 8, 8)
        alpha = tf.Variable(rng.uniform(0.1, 0.5, 8).astype(np.float32))

        @tf.function
        def f(x):
            return make(tf.nn.conv2d(x, w, 1, "SAME"), alpha)
        return freeze(f, tf.TensorSpec([1, 4, 4, 8], tf.float32))
    return build


def g_scale_mul(rng):
    w, scale, shift = var(rng, 1, 1, 8, 8), var(rng, 8, lo=0.5), var(rng, 8)

    @tf.function
    def f(x):
        return tf.nn.conv2d(x, w, 1, "SAME") * scale + shift
    return freeze(f, tf.TensorSpec([1, 4, 4, 8], tf.float32))


def g_preamble(rng):
    w, b = var(rng, 3, 3, 3, 8), var(rng, 8)
    wd, wp = var(rng, 3, 3, 8, 1), var(rng, 1, 1, 8, 5)

    @tf.function
    def f(x):
        y = tf.image.resize(tf.cast(x, tf.float32), [16, 16])
        y = y * (2.0 / 255.0) - 1.0
        y = tf.nn.relu6(tf.nn.bias_add(tf.nn.conv2d(y, w, 1, "SAME"), b))
        y = tf.nn.depthwise_conv2d(y, wd, [1, 1, 1, 1], "SAME")
        return tf.argmax(tf.nn.conv2d(y, wp, 1, "SAME"), axis=-1,
                         output_type=tf.int32)
    return freeze(f, tf.TensorSpec([1, 20, 24, 3], tf.uint8))


def g_full(rng):
    w1, b1 = var(rng, 3, 3, 3, 8), var(rng, 8)
    gamma, beta, mean = var(rng, 8), var(rng, 8), var(rng, 8)
    v, wdw = var(rng, 8, lo=0.5), var(rng, 3, 3, 8, 1)
    wup, whead = var(rng, 2, 2, 4, 8), var(rng, 1, 1, 4, 4)
    wfc, bfc = var(rng, 16 * 16 * 4, 6), var(rng, 6)

    @tf.function
    def f(x):
        y = tf.nn.bias_add(tf.nn.conv2d(x, w1, 1, "SAME"), b1)
        y, _, _ = tf.compat.v1.nn.fused_batch_norm(
            y, gamma, beta, mean, v, epsilon=1e-3, is_training=False)
        y = tf.nn.depthwise_conv2d(tf.nn.relu(y), wdw, [1, 1, 1, 1], "SAME")
        y = tf.nn.conv2d_transpose(y, wup, [1, 16, 16, 4], [1, 2, 2, 1],
                                   "VALID")
        y = tf.reshape(tf.nn.conv2d(y, whead, 1, "SAME"), [1, -1])
        return tf.linalg.matmul(y, wfc) + bfc
    return freeze(f, tf.TensorSpec([1, 8, 8, 3], tf.float32))


GRAPHS = {
    "conv_bias_bn": g_conv_bias_bn,
    "prelu_slim_abs": _prelu_graph(
        lambda y, a: tf.nn.relu(y) + a * (y - tf.abs(y)) * 0.5),
    "prelu_keras_neg_relu": _prelu_graph(
        lambda y, a: tf.nn.relu(y) + (-a) * tf.nn.relu(-y)),
    "prelu_sub_relu": _prelu_graph(
        lambda y, a: tf.nn.relu(y) - a * tf.nn.relu(-y)),
    "prelu_minimum": _prelu_graph(
        lambda y, a: tf.nn.relu(y) + a * tf.minimum(y, 0.0)),
    "scale_mul_not_prelu": g_scale_mul,
    "deeplab_preamble": g_preamble,
    "depthwise_transpose_matmul": g_full,
}


@pytest.mark.parametrize("form", sorted(GRAPHS))
def test_extract_ops_matches_jax(form):
    gd = GRAPHS[form](np.random.default_rng(42))
    got, want = conv.extract_ops(gd), jconv.extract_ops(gd)
    assert [(o.kind, o.name) for o in got] == [(o.kind, o.name)
                                               for o in want]
    assert got, form
    for g, w in zip(got, want):
        assert sorted(g.arrays) == sorted(w.arrays)
        for k in w.arrays:
            a, b = np.asarray(g.arrays[k]), np.asarray(w.arrays[k])
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (
                form, g.name, k)


# family: (JAX module, port module, example input (H, W))
FAMILIES = {
    "enet": (lambda: JENet(num_classes=15, dtype=jnp.float32),
             lambda: ENet(15), (32, 64)),
    "xception": (lambda: JX(middle_blocks=2, dtype=jnp.float32),
                 lambda: Xception65DeepLab(middle_blocks=2), (32, 32)),
    "deeplab": (lambda: JD(num_classes=15, dtype=jnp.float32),
                lambda: DeepLabV3(15), (32, 32)),
    "unet": (lambda: JU(num_classes=15, dtype=jnp.float32),
             lambda: UNet(15), (32, 32)),
    "segformer_b0": (lambda: JS(num_classes=15, dtype=jnp.float32,
                                chw_stages=0, chw_head=False),
                     lambda: SegFormer.preset("b0"), (64, 64)),
}


def jax_creation_order(module, hw):
    order = []
    with jconv._record_creations(order):
        jax.eval_shape(lambda x: module.init(jax.random.PRNGKey(0), x,
                                             train=False),
                       jnp.zeros((1,) + hw + (3,), jnp.float32))
    return list(dict.fromkeys(order))


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_param_creation_order_matches_jax(family):
    make_jax, make_port, hw = FAMILIES[family]
    module = make_port()
    tree, got = conv.param_creation_order(
        module, np.zeros((1,) + hw + (3,), np.float32))
    want = jax_creation_order(make_jax(), hw)
    assert got == want, family
    assert len(got) == len(module.state_dict())
    assert sorted(tree) == ["batch_stats", "params"]


class Jitted:
    """A Flax module whose ``init`` runs under ``jax.jit``: the JAX
    converter's interceptor records the same creations while tracing,
    and the init compiles once instead of op by op."""

    def __init__(self, module):
        self.module = module

    def init(self, key, x, train=False):
        return jax.jit(lambda k, a: self.module.init(k, a, train=train))(
            key, x)


def test_pour_enet_graph_matches_jax():
    """An ENet graph (the JAX exporter's, from seeded weights) poured by
    both converters: the port's state dict is the JAX tree through
    ``enet_state_dict``, and the seeded weights, bit for bit."""
    h, w = 32, 64
    tree = random_enet_variables(4)
    fwd, _ = jtf_enet.build_enet_tf(tree, 15, (h, w))
    ops = jconv.extract_ops(jtf_enet.freeze_function(
        fwd, tf.TensorSpec([None, 3, h, w], tf.float32)))
    got = conv.pour_into_module(ENet(15), np.zeros((1, h, w, 3)), ops)
    want = jconv.pour_into_module(
        Jitted(JENet(num_classes=15, dtype=jnp.float32)),
        jnp.zeros((1, h, w, 3)), ops)
    want = enet_state_dict(jax.tree_util.tree_map(np.asarray, want))
    seeded = enet_state_dict(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], seeded[k]), k


def test_pour_xception_graph_matches_jax():
    h = w = 32
    tree = random_xception_variables(5, middle_blocks=2, num_classes=7)
    fwd, _ = jtf_xc.build_xception_deeplab_tf(tree, 7, (h, w),
                                              middle_blocks=2)
    ops = jconv.extract_ops(jtf_enet.freeze_function(
        fwd, tf.TensorSpec([None, h, w, 3], tf.uint8)))
    got = conv.pour_into_module(
        Xception65DeepLab(num_classes=7, middle_blocks=2),
        np.zeros((1, h, w, 3)), ops)
    want = jconv.pour_into_module(
        Jitted(JX(num_classes=7, middle_blocks=2, dtype=jnp.float32)),
        jnp.zeros((1, h, w, 3)), ops)
    want = xception_state_dict(jax.tree_util.tree_map(np.asarray, want))
    seeded = xception_state_dict(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
        assert torch.equal(got[k], seeded[k]), k


class ConvBN(torch.nn.Module):
    """Conv_0 (3x3, 3 → 8, with bias) → BatchNorm_0."""

    def __init__(self):
        super().__init__()
        self.Conv_0 = Conv(3, 8, 3)
        self.BatchNorm_0 = BatchNorm(8, 1e-3)

    def forward(self, x):
        return self.BatchNorm_0(self.Conv_0(x))


def test_conv_shape_mismatch_names_the_leaf():
    rng = np.random.default_rng(0)
    w = var(rng, 3, 3, 3, 99)

    @tf.function
    def f(x):
        return tf.nn.conv2d(x, w, 1, "SAME")

    ops = conv.extract_ops(freeze(f, tf.TensorSpec([1, 8, 8, 3],
                                                   tf.float32)))
    with pytest.raises(ValueError, match=r"no conv-family graph op matches "
                                         r"Flax leaf Conv_0/kernel of shape "
                                         r"\(3, 3, 3, 8\)"):
        conv.pour_into_module(ConvBN(), np.zeros((1, 8, 8, 3)), ops)


def test_batchnorm_shape_mismatch_names_both():
    rng = np.random.default_rng(0)
    w, b = var(rng, 3, 3, 3, 8), var(rng, 8)
    gamma, beta, mean, v = var(rng, 5), var(rng, 5), var(rng, 5), var(
        rng, 5, lo=0.5)

    @tf.function
    def f(x):
        y = tf.nn.bias_add(tf.nn.conv2d(x, w, 1, "SAME"), b)
        y = tf.reduce_mean(y, axis=-1, keepdims=True) * tf.ones([1, 1, 1, 5])
        y, _, _ = tf.compat.v1.nn.fused_batch_norm(
            y, gamma, beta, mean, v, epsilon=1e-3, is_training=False)
        return y

    ops = conv.extract_ops(freeze(f, tf.TensorSpec([1, 8, 8, 3],
                                                   tf.float32)))
    bn = [o.name for o in ops if o.kind == "batchnorm"][0]
    with pytest.raises(ValueError, match=(
            rf"pouring graph op '{bn}' into .*BatchNorm_0/\w+: graph "
            r"\(5,\) vs model \(8,\)")):
        conv.pour_into_module(ConvBN(), np.zeros((1, 8, 8, 3)), ops)
