"""Flax UNet variables → the port's ``state_dict``.

The strict bridge of ``convert/flax_tree.py`` onto ``models/unet.py``'s
:class:`~..models.unet.UNet` (its classes read from the tree): every leaf
used once, every shape checked.  The transposed convs ``up0``-``up3``
(Flax kernel (2, 2, in, out), applied unflipped) → ``weight`` (in, out,
2, 2) flipped in both spatial axes; every other conv HWIO → OIHW.
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .flax_tree import classifier_width, random_variables, strict_state_dict


def unet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax UNet variable tree (numpy leaves) → the port's state dict,
    checked leaf for leaf against the port's model."""
    from ..models.unet import UP_CONVS, UNet   # the port's names

    return strict_state_dict(
        variables, UNet(num_classes=classifier_width(variables, "a UNet")),
        transposed=UP_CONVS)


def random_unet_variables(seed: int = 0, num_classes: int = 15) -> dict:
    """A Flax-layout UNet variable tree of numpy arrays, made from
    ``seed`` (``flax_tree.random_variables``)."""
    from ..models.unet import UP_CONVS, UNet

    return random_variables(UNet(num_classes=num_classes), seed,
                            transposed=UP_CONVS)


__all__ = ["unet_state_dict", "random_unet_variables"]
