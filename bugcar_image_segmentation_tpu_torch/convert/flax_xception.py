"""Flax Xception-65 DeepLab variables → the port's ``state_dict``.

The strict bridge of ``convert/flax_tree.py`` onto ``models/xception.py``
(its middle-flow depth and classes read from the tree): every leaf used
once, every shape checked.  The stem's ``conv1_1/Conv_0`` (3, 3, 3, 32)
converts like any other conv (the JAX package's space-to-depth stem twin
has the same tree).
"""

from __future__ import annotations

from typing import Dict, Mapping

import torch

from .flax_tree import classifier_width, random_variables, strict_state_dict


def _tree_geometry(variables: Mapping):
    """(middle blocks, classes) of a Flax Xception tree."""
    classes = classifier_width(variables, "an Xception-65 DeepLab")
    middle = sum(1 for k in variables["params"] if str(k).startswith("middle"))
    return middle, classes


def xception_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax Xception65DeepLab variable tree (numpy leaves) → the port's
    state dict, checked leaf for leaf against the port's model."""
    from ..models.xception import Xception65DeepLab   # the port's names

    middle, classes = _tree_geometry(variables)
    return strict_state_dict(variables, Xception65DeepLab(
        num_classes=classes, middle_blocks=middle))


def random_xception_variables(seed: int = 0, middle_blocks: int = 16,
                              num_classes: int = 15) -> dict:
    """A Flax-layout Xception-65 DeepLab variable tree of numpy arrays,
    made from ``seed`` (``flax_tree.random_variables``).  The middle
    flow's identity skips carry the signal through the 65 layers: a seeded
    engine's logits still tell pixels apart (several classes win on
    synthetic frames)."""
    from ..models.xception import Xception65DeepLab

    return random_variables(Xception65DeepLab(num_classes=num_classes,
                                              middle_blocks=middle_blocks),
                            seed)


__all__ = ["xception_state_dict", "random_xception_variables"]
