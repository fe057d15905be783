"""Flax SegFormer variables → the port's SegFormer ``state_dict``.

Takes the JAX package's ``{"params": ..., "batch_stats": ...}`` tree with
numpy leaves (the NHWC and the transposed JAX forwards share one tree)
and returns tensors keyed as ``models/segformer.py`` names them:

- conv ``kernel`` (HWIO; depthwise (3, 3, 1, C)) → ``weight`` (OIHW);
- Dense ``kernel`` (in, out) → ``weight`` (out, in);
- LayerNorm and BatchNorm ``scale``/``bias`` as they are, BatchNorm
  running ``mean``/``var`` (``batch_stats``) → buffers.

Pure numpy + torch: reading msgpack needs flax, which the port does not
import; the caller restores the tree.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .flax_enet import _leaves
from .flax_tree import random_variables


def segformer_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax SegFormer variable tree (numpy leaves) → the port's state
    dict."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            name = path[-1]
            if name == "kernel":
                leaf = leaf.transpose(3, 2, 0, 1) if leaf.ndim == 4 else leaf.T
                name = "weight"
            key = ".".join(path[:-1] + (name,))
            out[key] = torch.tensor(np.ascontiguousarray(leaf, np.float32))
    return out


def random_segformer_variables(seed: int = 0, size: str = "b0",
                               num_classes: int = 15, **overrides) -> dict:
    """A Flax-layout SegFormer-``size`` variable tree of numpy arrays,
    made from ``seed`` (``flax_tree.random_variables``).  ``overrides``
    (widths, depths, decoder_dim, ...) replace the preset's."""
    from ..models.segformer import SegFormer   # the shapes come from the port

    return random_variables(
        SegFormer.preset(size, num_classes=num_classes, **overrides), seed)


__all__ = ["segformer_state_dict", "random_segformer_variables"]
