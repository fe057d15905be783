"""Flax ENet variables → the port's ENet ``state_dict``.

Takes the JAX package's ``{"params": ..., "batch_stats": ...}`` tree with
numpy leaves (e.g. ``flax.serialization.msgpack_restore`` of a committed
checkpoint, or a tree made from a seed) and returns tensors keyed as
``models/enet.py`` names them:

- conv ``kernel`` (HWIO) → ``weight`` (OIHW);
- transposed-conv ``kernel`` (Flax: HWIO, applied unflipped over the
  dilated input) → ``weight`` in ``conv_transpose2d`` layout (in, out, kh,
  kw), spatially flipped;
- ``bias``, BatchNorm ``scale``/``bias`` and PReLU ``alpha`` as they are;
- BatchNorm running ``mean``/``var`` (``batch_stats``) → buffers.

Pure numpy + torch: reading msgpack needs flax, which the port does not
import; the caller restores the tree.
"""

from __future__ import annotations

from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

# Modules whose "kernel" is a Flax ConvTranspose.
TRANSPOSED = ("deconv", "fullconv")


def _leaves(tree: Mapping, prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _leaves(value, prefix + (str(key),))
        else:
            yield prefix + (str(key),), np.asarray(value)


def _convert(path: Tuple[str, ...], leaf: np.ndarray) -> Tuple[str, np.ndarray]:
    name = path[-1]
    if name == "kernel":
        if path[-2] in TRANSPOSED:
            return "weight", np.flip(leaf, (0, 1)).transpose(2, 3, 0, 1)
        return "weight", leaf.transpose(3, 2, 0, 1)
    return name, leaf


def enet_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax ENet variable tree (numpy leaves) → the port's state dict."""
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            name, value = _convert(path, leaf)
            key = ".".join(path[:-1] + (name,))
            out[key] = torch.tensor(np.ascontiguousarray(value, np.float32))
    return out


def random_enet_variables(seed: int = 0) -> dict:
    """A Flax-layout ENet variable tree of numpy arrays, made from ``seed``:
    LeCun-normal kernels and non-trivial BatchNorm statistics and PReLU
    slopes, so folding and every slope matter."""
    from ..models.enet import ENet   # the tree's shapes come from the port

    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}
    for key, t in ENet().state_dict().items():
        path = key.split(".")
        shape = tuple(t.shape)
        if path[-1] == "weight":
            transposed = path[-2] in TRANSPOSED
            # back to the Flax kernel layout (kh, kw, in, out)
            kh, kw = shape[2], shape[3]
            cin, cout = (shape[0], shape[1]) if transposed else (shape[1],
                                                                  shape[0])
            leaf = (rng.standard_normal((kh, kw, cin, cout))
                    / np.sqrt(kh * kw * cin))
            path[-1] = "kernel"
            tree = params
        elif path[-1] in ("mean", "var"):
            leaf = (rng.uniform(-0.2, 0.2, shape) if path[-1] == "mean"
                    else rng.uniform(0.5, 1.5, shape))
            tree = stats
        elif path[-1] == "scale":
            leaf, tree = rng.uniform(0.7, 1.3, shape), params
        elif path[-1] == "alpha":
            leaf, tree = rng.uniform(0.05, 0.4, shape), params
        else:   # BatchNorm / conv bias
            leaf, tree = rng.uniform(-0.1, 0.1, shape), params
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf.astype(np.float32)
    return {"params": params, "batch_stats": stats}


__all__ = ["enet_state_dict", "random_enet_variables", "TRANSPOSED"]
