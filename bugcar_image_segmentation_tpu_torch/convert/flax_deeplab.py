"""Flax MobileNetV2 DeepLab variables → the port's ``state_dict``.

The strict bridge of ``convert/flax_tree.py`` onto ``models/deeplab.py``'s
:class:`~..models.deeplab.DeepLabV3` (its classes read from the tree):
every leaf used once, every shape checked.  The stem's ``stem/Conv_0``
(3, 3, 3, 32) converts like any other conv (the JAX package's
space-to-depth stem twin has the same tree); the depthwise kernels (3, 3,
1, C) → (C, 1, 3, 3).
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .flax_tree import classifier_width, random_variables, strict_state_dict

CALIBRATION_HW = (64, 128)   # the seeded tree's calibration frame (H, W)
CALIBRATED = ("stem", "ir1", "ir2", "low_proj", "dec0", "dec1")


def deeplab_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax DeepLabV3 (MobileNetV2) variable tree (numpy leaves) → the
    port's state dict, checked leaf for leaf against the port's model."""
    from ..models.deeplab import DeepLabV3   # the port's names

    return strict_state_dict(variables, DeepLabV3(
        num_classes=classifier_width(variables, "a MobileNetV2 DeepLab")))


def random_deeplab_variables(seed: int = 0, num_classes: int = 15) -> dict:
    """A Flax-layout MobileNetV2 DeepLab variable tree of numpy arrays,
    made from ``seed``: ``flax_tree.random_variables``, then the running
    statistics of the BatchNorms on the decoder's 1/4-resolution path
    (the stem, ``ir1``, ``ir2_*``, ``low_proj``, ``dec0``, ``dec1``) set
    to the batch statistics of their inputs on one synthetic road scene
    (made from ``seed`` too), layer after layer.  With LeCun kernels alone
    the features lose their spatial variation and one class wins every
    pixel; calibrating every BatchNorm makes the 17 blocks amplify bf16
    rounding (labels of an f32 and a bf16 run agree on ~0.77 of the
    pixels); calibrating this path alone gives several classes and the
    bf16 agreement of the other seeded engines."""
    from ..models.deeplab import DeepLabV3
    from ..models.layers import BatchNorm
    from ..models.preprocess import preprocess_frame
    from ..synthetic import road_scene

    model = DeepLabV3(num_classes)
    tree = random_variables(model, seed)
    model.load_state_dict(deeplab_state_dict(tree))
    frame, _ = road_scene(np.random.default_rng(seed), CALIBRATION_HW)
    x = preprocess_frame(torch.from_numpy(frame)[None], CALIBRATION_HW,
                         dtype=torch.float32)

    def calibrate(bn: BatchNorm, inputs) -> None:
        v = inputs[0].float()
        bn.mean.copy_(v.mean(dim=(0, 1, 2)))
        bn.var.copy_(v.var(dim=(0, 1, 2), unbiased=False))

    bns = {name: m for name, m in model.named_modules()
           if isinstance(m, BatchNorm) and name.startswith(CALIBRATED)}
    hooks = [m.register_forward_pre_hook(calibrate) for m in bns.values()]
    try:
        with torch.no_grad():
            model(x)
    finally:
        for h in hooks:
            h.remove()
    for name, m in bns.items():
        node = tree["batch_stats"]
        for p in name.split("."):
            node = node[p]
        node["mean"] = m.mean.numpy().copy()
        node["var"] = m.var.numpy().copy()
    return tree


__all__ = ["deeplab_state_dict", "random_deeplab_variables"]
