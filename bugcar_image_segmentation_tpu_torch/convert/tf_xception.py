"""DeepLab Xception-65's frozen TF1 graph, written from the port's weights.

Port of ``bugcar_image_segmentation_tpu/convert/tf_xception.py``.  The
reference's ``deeplab.pb`` is the official DeepLab frozen export:
Xception-65, ASPP and decoder inside the export envelope the reference
engine relies on: a uint8 ``ImageTensor:0`` input, embedded ``*(2/255)-1``
preprocessing and a final ArgMax producing ``SemanticPredictions:0``
(class maps, not logits).  :func:`build_xception_deeplab_tf` rebuilds
that graph -- DepthwiseConv2dNative + pointwise Conv2D pairs,
FusedBatchNorm everywhere, the preprocessing and argmax -- from a port
``Xception65DeepLab`` or its Flax-layout tree, statement for statement
in the order the converter (:mod:`.tf_graphdef`) zips.  TensorFlow is
imported inside the functions: offline tooling only.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .tf_enet import _bn, _tf, flax_tree


def _flax_to_tf_tree(variables) -> dict:
    """tf.Variable tree from a port model or its Flax tree; depthwise
    kernels re-laid out to TF's (H, W, C, multiplier) on the numpy
    values (the inverse of :func:`.tf_graphdef.convert_depthwise_kernel`).
    """
    tf = _tf()

    def walk(tree, path):
        if isinstance(tree, dict):
            return {k: walk(v, path + (k,)) for k, v in tree.items()}
        arr = np.asarray(tree, np.float32)
        if path[-1] == "kernel" and len(path) >= 2 \
                and path[-2] == "depthwise":
            h, w, one, c = arr.shape
            arr = arr.reshape(h, w, 1, c).transpose(0, 1, 3, 2)
        return tf.Variable(arr, name="/".join(path))

    variables = flax_tree(variables)
    return walk({"params": variables["params"],
                 "batch_stats": variables.get("batch_stats", {})}, ())


def _conv_bn(x, p, s, strides=1, dilations=1, act=True):
    """TF mirror of models/deeplab.py ConvBN (relu6=False flavour)."""
    tf = _tf()
    x = tf.nn.conv2d(x, p["Conv_0"]["kernel"], strides, "SAME",
                     dilations=dilations)
    x = _bn(x, p["BatchNorm_0"], s["BatchNorm_0"])
    if act:
        x = tf.nn.relu(x)
    return x


def _sepconv(x, p, s, strides=1, dilation=1, act_out=True):
    """TF mirror of models/xception.py SepConvBN: the real export's
    DepthwiseConv2dNative → FusedBatchNorm → Relu → Conv2D →
    FusedBatchNorm (→ Relu) chain."""
    tf = _tf()
    x = tf.nn.depthwise_conv2d(x, p["depthwise"]["kernel"],
                               [1, strides, strides, 1], "SAME",
                               dilations=[dilation, dilation])
    x = _bn(x, p["depthwise_bn"], s["depthwise_bn"])
    x = tf.nn.relu(x)
    x = tf.nn.conv2d(x, p["pointwise"]["kernel"], 1, "SAME")
    x = _bn(x, p["pointwise_bn"], s["pointwise_bn"])
    if act_out:
        x = tf.nn.relu(x)
    return x


def _block(x, p, s, strides=1, dilation=1, skip="conv"):
    """TF mirror of models/xception.py XceptionBlock."""
    tf = _tf()
    y = _sepconv(x, p["sep0"], s["sep0"], dilation=dilation)
    mid = _sepconv(y, p["sep1"], s["sep1"], dilation=dilation)
    y = _sepconv(mid, p["sep2"], s["sep2"], strides=strides,
                 dilation=dilation, act_out=False)
    if skip == "conv":
        sc = tf.nn.conv2d(x, p["shortcut"]["kernel"], strides, "SAME")
        sc = _bn(sc, p["shortcut_bn"], s["shortcut_bn"])
        y = y + sc
    elif skip == "sum":
        y = y + x
    return y, mid


def build_xception_deeplab_tf(variables, num_classes: int,
                              input_hw: Tuple[int, int],
                              middle_blocks: int = 16):
    """(traced_fn, tf_variables): the full DeepLab-export stand-in.

    ``traced_fn`` takes uint8 NHWC ``ImageTensor`` and returns int32
    class predictions named ``SemanticPredictions`` — the reference's
    exact tensor contract (models.py:100-101), preprocessing and argmax
    embedded in the graph.
    """
    tf = _tf()
    h, w = input_hw
    if h % 16 or w % 16:
        raise ValueError(f"H, W must divide by 16, got {input_hw}")
    tree = _flax_to_tf_tree(variables)

    @tf.function
    def forward(ImageTensor):
        p, s = tree["params"], tree["batch_stats"]
        # Embedded preprocessing: uint8 → [-1, 1] floats.
        x = tf.cast(ImageTensor, tf.float32)
        x = x * (2.0 / 255.0) - 1.0

        # Entry flow.
        y = _conv_bn(x, p["conv1_1"], s["conv1_1"], strides=2)
        y = _conv_bn(y, p["conv1_2"], s["conv1_2"])
        y, _ = _block(y, p["block1"], s["block1"], strides=2)
        y, low = _block(y, p["block2"], s["block2"], strides=2)
        y, _ = _block(y, p["block3"], s["block3"], strides=2)

        # Middle flow.
        for i in range(middle_blocks):
            y, _ = _block(y, p[f"middle{i}"], s[f"middle{i}"], skip="sum")

        # Exit flow (stride 1 + dilation 2: output stride 16).
        y, _ = _block(y, p["exit1"], s["exit1"], dilation=2)
        y = _sepconv(y, p["exit_sep0"], s["exit_sep0"], dilation=2)
        y = _sepconv(y, p["exit_sep1"], s["exit_sep1"], dilation=2)
        y = _sepconv(y, p["exit_sep2"], s["exit_sep2"], dilation=2)

        # ASPP (mirrors models/deeplab.py ASPP module order).
        pa, sa = p["aspp"], s["aspp"]
        branches = [_conv_bn(y, pa["b0"], sa["b0"])]
        for i, r in enumerate((6, 12, 18)):
            branches.append(_conv_bn(y, pa[f"b{i + 1}"], sa[f"b{i + 1}"],
                                     dilations=(r, r)))
        pooled = tf.reduce_mean(y, axis=[1, 2], keepdims=True)
        pooled = _conv_bn(pooled, pa["image_pool"], sa["image_pool"])
        pooled = tf.broadcast_to(
            pooled, tf.stack([tf.shape(y)[0], tf.shape(y)[1],
                              tf.shape(y)[2], tf.shape(pooled)[3]]))
        branches.append(pooled)
        y = tf.concat(branches, axis=-1)
        y = _conv_bn(y, pa["merge"], sa["merge"])

        # Decoder.
        ll_hw = [h // 4, w // 4]
        y = tf.image.resize(y, ll_hw, method="bilinear")
        ll = _conv_bn(low, p["low_proj"], s["low_proj"])
        y = tf.concat([y, ll], axis=-1)
        y = _conv_bn(y, p["dec0"], s["dec0"])
        y = _conv_bn(y, p["dec1"], s["dec1"])
        y = tf.nn.conv2d(y, p["classifier"]["kernel"], 1, "SAME")
        y = tf.nn.bias_add(y, p["classifier"]["bias"])
        y = tf.image.resize(y, [h, w], method="bilinear")

        # Embedded argmax: the export returns class maps, not logits.
        preds = tf.argmax(y, axis=-1, output_type=tf.int32)
        return tf.identity(preds, name="SemanticPredictions")

    return forward, tree


def export_deeplab_pb(variables, num_classes: int,
                      input_hw: Tuple[int, int], path: str,
                      middle_blocks: int = 16):
    """A port Xception-65 DeepLab (or its Flax-layout tree) → frozen
    ``deeplab.pb``-shaped GraphDef (``ImageTensor:0`` uint8 →
    ``SemanticPredictions:0``)."""
    tf = _tf()
    from .tf_enet import freeze_function

    h, w = input_hw
    forward, _tree = build_xception_deeplab_tf(variables, num_classes,
                                               input_hw, middle_blocks)
    return freeze_function(
        forward,
        tf.TensorSpec([None, h, w, 3], tf.uint8, name="ImageTensor"),
        path)


__all__ = ["build_xception_deeplab_tf", "export_deeplab_pb"]
