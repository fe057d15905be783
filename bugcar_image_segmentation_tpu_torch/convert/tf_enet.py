"""ENet's frozen TF1 graph, written from the port's weights.

Port of ``bugcar_image_segmentation_tpu/convert/tf_enet.py``.  Two jobs,
one graph:

1. **The deploy bridge back to the reference's format**: its train →
   deploy artifact is a frozen TF1 GraphDef (``freeze_session``) served
   by ``ENET`` through ``tf.import_graph_def`` + ``Session.run`` on
   ``input0:0`` → ``CATkrIDy/concat:0``.  :func:`export_enet_pb` takes a
   port ENet (or its Flax-layout tree, ``flax_tree.flax_variables``) and
   writes exactly that artifact: the same tensor names, NCHW in and out,
   weights frozen to constants, device placements cleared.

2. **Graphs with a TF1 ENet export's op patterns** for the converter
   (:mod:`.tf_graphdef`): decomposed PReLU (``relu(x) + alpha*(x-|x|)*
   0.5``; stock TF1 has no ``Prelu`` op), ``MaxPoolWithArgmax`` +
   ``ScatterNd`` unpooling, ``FusedBatchNorm`` and
   ``Conv2DBackpropInput``.

:func:`build_enet_tf` mirrors the ENet forward statement for
statement, so the frozen graph executes in Flax parameter-creation
order, the invariant the order-zipping converter relies on.  TensorFlow
is imported inside the functions: offline tooling only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


def _tf():
    import tensorflow as tf  # deferred: offline tooling only
    return tf


# ---------------------------------------------------------------------------
# Flax variable tree → tf.Variable tree
# ---------------------------------------------------------------------------


def flax_tree(variables) -> dict:
    """A port module's Flax-layout tree (``flax_tree.flax_variables``), or
    ``variables`` if it is a tree already."""
    if hasattr(variables, "state_dict"):
        from .flax_tree import flax_variables
        return flax_variables(variables)
    return variables


def _flax_to_tf_tree(variables) -> dict:
    """Nested dict of tf.Variables mirroring the Flax variable tree (of a
    port module or a tree, :func:`flax_tree`).

    ConvTranspose kernels are re-laid out to TF's ``Conv2DBackpropInput``
    convention here, on the *numpy* values — doing it in-graph would put
    Reverse/Transpose nodes between the constant and the conv op and
    break the converter's const resolution.  The transform
    (mirror spatial, swap in/out) is the exact inverse of
    :func:`.tf_graphdef.convert_deconv_kernel` (an involution).
    """
    tf = _tf()

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        arr = np.asarray(tree, np.float32)
        if path[-1] == "kernel" and len(path) >= 2 and \
                path[-2] in ("deconv", "fullconv"):
            arr = arr[::-1, ::-1].transpose(0, 1, 3, 2)
        return tf.Variable(arr, name="/".join(path))

    variables = flax_tree(variables)
    return walk({"params": variables["params"],
                 "batch_stats": variables.get("batch_stats", {})}, ())


# ---------------------------------------------------------------------------
# Era-correct building blocks (used inside the traced function)
# ---------------------------------------------------------------------------


def _prelu(x, alpha):
    """Decomposed PReLU, the TF1/slim idiom: relu(x) + a*(x-|x|)*0.5."""
    tf = _tf()
    pos = tf.nn.relu(x)
    neg = alpha * (x - tf.abs(x)) * 0.5
    return pos + neg


def _bn(x, p, s, eps=1e-3):
    """Inference FusedBatchNorm from Flax BatchNorm params/stats."""
    tf = _tf()
    y, _, _ = tf.compat.v1.nn.fused_batch_norm(
        x, p["scale"], p["bias"], mean=s["mean"], variance=s["var"],
        epsilon=eps, is_training=False)
    return y


def _conv_bn_act(x, p, s, strides=1, dilations=1, act=True):
    """TF mirror of models/enet.py ConvBNAct (same sub-module names)."""
    tf = _tf()
    x = tf.nn.conv2d(x, p["Conv_0"]["kernel"], strides, "SAME",
                     dilations=dilations)
    x = _bn(x, p["BatchNorm_0"], s["BatchNorm_0"])
    if act:
        x = _prelu(x, p["PReLU_0"]["alpha"])
    return x


def _unpool_scatter(updates, mask, out_hw: Tuple[int, int], channels: int):
    """ScatterNd unpooling from MaxPoolWithArgmax flat indices.

    The TF1-era decoder idiom: decode ``(y*W + x)*C + c`` indices
    (``include_batch_in_index=False``) into (b, y, x, c) coordinates and
    scatter the pooled values into the double-resolution canvas.
    Semantically identical to models/enet.py max_unpool's one-hot
    placement — first-max tie rule on both sides.
    """
    tf = _tf()
    mask = tf.cast(mask, tf.int32)
    n = tf.shape(updates)[0]
    oh, ow = out_hw
    one = tf.ones_like(mask, dtype=tf.int32)
    b = one * tf.reshape(tf.range(n), [-1, 1, 1, 1])
    y = mask // (ow * channels)
    x = (mask // channels) % ow
    f = one * tf.reshape(tf.range(channels), [1, 1, 1, -1])
    idx = tf.transpose(tf.reshape(tf.stack([b, y, x, f]), [4, -1]))
    return tf.scatter_nd(idx, tf.reshape(updates, [-1]),
                         tf.stack([n, oh, ow, channels]))


def _bottleneck(x, p, s, features, kind, dilation=1,
                pool_idx=None, unpool_hw=None):
    """TF mirror of models/enet.py Bottleneck — identical statement order
    so the frozen graph executes in Flax parameter-creation order."""
    tf = _tf()

    if kind == "down":
        y = _conv_bn_act(x, p["proj"], s["proj"], strides=2)
    else:
        y = _conv_bn_act(x, p["proj"], s["proj"])

    if kind == "asymmetric":
        y = tf.nn.conv2d(y, p["conv_5x1"]["kernel"], 1, "SAME")
        y = _conv_bn_act(y, p["conv_1x5"], s["conv_1x5"])
    elif kind == "up":
        kern = p["deconv"]["kernel"]  # already TF layout (H, W, out, in)
        mid = kern.shape[2]
        n = tf.shape(y)[0]
        out_shape = tf.stack([n, unpool_hw[0], unpool_hw[1], mid])
        y = tf.nn.conv2d_transpose(y, kern, out_shape, strides=2,
                                   padding="SAME")
        y = _bn(y, p["deconv_bn"], s["deconv_bn"])
        y = _prelu(y, p["deconv_act"]["alpha"])
    else:
        y = _conv_bn_act(y, p["conv"], s["conv"],
                         dilations=(dilation, dilation))

    y = _conv_bn_act(y, p["expand"], s["expand"], act=False)
    # (spatial dropout is a no-op at inference; the frozen graph omits it)

    new_idx = None
    if kind == "down":
        skip, new_idx = tf.nn.max_pool_with_argmax(x, 2, 2, "SAME")
        pad = features - skip.shape[-1]
        if pad > 0:
            skip = tf.pad(skip, [[0, 0], [0, 0], [0, 0], [0, pad]])
    elif kind == "up":
        skip = _conv_bn_act(x, p["skip_proj"], s["skip_proj"], act=False)
        skip = _unpool_scatter(skip, pool_idx, unpool_hw, skip.shape[-1])
    else:
        skip = x

    return _prelu(y + skip, p["out_act"]["alpha"]), new_idx


# ---------------------------------------------------------------------------
# Full network + freeze
# ---------------------------------------------------------------------------


def build_enet_tf(variables, num_classes: int, input_hw: Tuple[int, int]):
    """(traced_fn, tf_variables): TF twin of ENet from a port ENet or its
    Flax-layout tree.

    ``traced_fn`` takes NCHW float32 ``input0`` (the reference's tensor
    contract, models.py:15,52) and returns NCHW logits named
    ``CATkrIDy/concat`` — internally it computes in NHWC (TF's CPU conv
    kernels require it; transposes only at the boundaries).
    """
    tf = _tf()
    h, w = input_hw
    if h % 8 or w % 8:
        raise ValueError(f"H, W must divide by 8, got {input_hw}")
    tree = _flax_to_tf_tree(variables)

    @tf.function
    def forward(input0):
        p, s = tree["params"], tree["batch_stats"]
        x = tf.transpose(input0, [0, 2, 3, 1])  # NCHW → NHWC

        # Initial block: 3x3/2 conv(13) ‖ 2x2 max pool, BN, PReLU.
        conv = tf.nn.conv2d(x, p["initial"]["Conv_0"]["kernel"], 2, "SAME")
        pool = tf.nn.max_pool2d(x, 2, 2, "SAME")
        x = tf.concat([conv, pool], axis=-1)
        x = _bn(x, p["initial"]["BatchNorm_0"],
                s["initial"]["BatchNorm_0"])
        x = _prelu(x, p["initial"]["PReLU_0"]["alpha"])

        # Stage 1 (encoder, 1/4, 64ch)
        x, idx1 = _bottleneck(x, p["b1_0"], s["b1_0"], 64, "down")
        for i in range(1, 5):
            x, _ = _bottleneck(x, p[f"b1_{i}"], s[f"b1_{i}"], 64, "regular")

        # Stage 2/3 (encoder, 1/8, 128ch)
        x, idx2 = _bottleneck(x, p["b2_0"], s["b2_0"], 128, "down")
        for stage in (2, 3):
            x, _ = _bottleneck(x, p[f"b{stage}_1"], s[f"b{stage}_1"],
                               128, "regular")
            x, _ = _bottleneck(x, p[f"b{stage}_2"], s[f"b{stage}_2"],
                               128, "dilated", dilation=2)
            x, _ = _bottleneck(x, p[f"b{stage}_3"], s[f"b{stage}_3"],
                               128, "asymmetric")
            x, _ = _bottleneck(x, p[f"b{stage}_4"], s[f"b{stage}_4"],
                               128, "dilated", dilation=4)
            x, _ = _bottleneck(x, p[f"b{stage}_5"], s[f"b{stage}_5"],
                               128, "regular")
            x, _ = _bottleneck(x, p[f"b{stage}_6"], s[f"b{stage}_6"],
                               128, "dilated", dilation=8)
            x, _ = _bottleneck(x, p[f"b{stage}_7"], s[f"b{stage}_7"],
                               128, "asymmetric")
            x, _ = _bottleneck(x, p[f"b{stage}_8"], s[f"b{stage}_8"],
                               128, "dilated", dilation=16)

        # Stage 4 (decoder, back to 1/4, 64ch)
        x, _ = _bottleneck(x, p["b4_0"], s["b4_0"], 64, "up",
                           pool_idx=idx2, unpool_hw=(h // 4, w // 4))
        x, _ = _bottleneck(x, p["b4_1"], s["b4_1"], 64, "regular")
        x, _ = _bottleneck(x, p["b4_2"], s["b4_2"], 64, "regular")

        # Stage 5 (decoder, back to 1/2, 16ch)
        x, _ = _bottleneck(x, p["b5_0"], s["b5_0"], 16, "up",
                           pool_idx=idx1, unpool_hw=(h // 2, w // 2))
        x, _ = _bottleneck(x, p["b5_1"], s["b5_1"], 16, "regular")

        # Full-resolution classifier head (deconv + bias).
        kern = p["fullconv"]["kernel"]
        n = tf.shape(x)[0]
        out_shape = tf.stack([n, h, w, num_classes])
        x = tf.nn.conv2d_transpose(x, kern, out_shape, strides=2,
                                   padding="SAME")
        x = tf.nn.bias_add(x, p["fullconv"]["bias"])

        # NHWC → the reference's NCHW logits, under its output name
        # (reference models.py:16, 52).
        x = tf.transpose(x, [0, 3, 1, 2])
        return tf.identity(x, name="CATkrIDy/concat")

    return forward, tree


def freeze_function(fn, input_spec, path: str | None = None):
    """``freeze_session`` equivalent (reference utils.py:49-83) for TF2.

    Traces ``fn``, folds every variable to a constant, clears device
    placements for portability (reference utils.py:78-80), optionally
    serializes to ``path``.  Returns the frozen GraphDef.
    """
    from tensorflow.python.framework.convert_to_constants import (
        convert_variables_to_constants_v2)

    concrete = fn.get_concrete_function(input_spec)
    frozen = convert_variables_to_constants_v2(concrete)
    graph_def = frozen.graph.as_graph_def()
    for node in graph_def.node:
        node.device = ""
    if path is not None:
        with open(path, "wb") as f:
            f.write(graph_def.SerializeToString())
    return graph_def


def export_enet_pb(variables, num_classes: int, input_hw: Tuple[int, int],
                   path: str):
    """A trained port ENet (or its Flax-layout tree) → frozen
    ``enet.pb``-shaped GraphDef.

    The emitted graph is a drop-in for the reference's ``ENET`` loader:
    ``tf.import_graph_def(name='')`` then ``sess.run('CATkrIDy/concat:0',
    {'input0:0': nchw_batch})``.  Round-trips through
    :func:`.tf_graphdef.convert_frozen_graph` (tested in
    tests/test_tf_enet_bridge.py).
    """
    tf = _tf()
    h, w = input_hw
    forward, _tree = build_enet_tf(variables, num_classes, input_hw)
    return freeze_function(
        forward, tf.TensorSpec([None, 3, h, w], tf.float32, name="input0"),
        path)


__all__ = ["build_enet_tf", "freeze_function", "export_enet_pb",
           "flax_tree"]
