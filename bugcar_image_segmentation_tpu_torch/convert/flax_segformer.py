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
    made from ``seed``: LeCun-normal kernels, non-trivial LayerNorm and
    BatchNorm scales and biases and BatchNorm statistics, so that every
    parameter matters.  ``overrides`` (widths, depths, decoder_dim, ...)
    replace the preset's."""
    from ..models.segformer import SegFormer   # the shapes come from the port

    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}
    model = SegFormer.preset(size, num_classes=num_classes, **overrides)
    for key, t in model.state_dict().items():
        path = key.split(".")
        shape = tuple(t.shape)
        tree = params
        if path[-1] == "weight":
            if len(shape) == 4:     # OIHW → HWIO
                kshape = (shape[2], shape[3], shape[1], shape[0])
            else:                   # (out, in) → (in, out)
                kshape = (shape[1], shape[0])
            fan_in = int(np.prod(kshape[:-1]))
            leaf = rng.standard_normal(kshape) / np.sqrt(fan_in)
            path[-1] = "kernel"
        elif path[-1] in ("mean", "var"):
            leaf = (rng.uniform(-0.2, 0.2, shape) if path[-1] == "mean"
                    else rng.uniform(0.5, 1.5, shape))
            tree = stats
        elif path[-1] == "scale":
            leaf = rng.uniform(0.7, 1.3, shape)
        else:   # Dense / conv / LayerNorm / BatchNorm bias
            leaf = rng.uniform(-0.1, 0.1, shape)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf.astype(np.float32)
    return {"params": params, "batch_stats": stats}


__all__ = ["segformer_state_dict", "random_segformer_variables"]
