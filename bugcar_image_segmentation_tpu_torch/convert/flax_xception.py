"""Flax Xception-65 DeepLab variables → the port's ``state_dict``.

Takes the JAX package's ``{"params": ..., "batch_stats": ...}`` tree with
numpy leaves (float32 or bfloat16, as the committed checkpoint stores
them) and returns float32 tensors keyed as ``models/xception.py`` names
them:

- conv ``kernel`` (HWIO) → ``weight`` (OIHW): the depthwise (3, 3, 1, C) →
  (C, 1, 3, 3), a pointwise (1, 1, C, F) → (F, C, 1, 1), the stem's
  ``conv1_1/Conv_0`` (3, 3, 3, 32) like any other (the JAX package's
  space-to-depth stem twin has the same tree);
- ``bias``, BatchNorm ``scale``/``bias`` as they are, BatchNorm running
  ``mean``/``var`` (``batch_stats``) → buffers.

Every leaf is consumed exactly once: a leaf the port has no place for, a
place no leaf fills, or a shape that does not fit raises ``ValueError``.
Pure numpy + torch; the caller restores the tree.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

from .flax_enet import _leaves


def _tree_geometry(variables: Mapping):
    """(middle blocks, classes) of a Flax Xception tree."""
    params = variables.get("params", {})
    middle = sum(1 for k in params if str(k).startswith("middle"))
    try:
        classes = np.shape(params["classifier"]["kernel"])[-1]
    except KeyError as exc:
        raise ValueError("not an Xception-65 DeepLab tree: no "
                         "params/classifier/kernel") from exc
    return middle, int(classes)


def xception_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """Flax Xception65DeepLab variable tree (numpy leaves) → the port's
    state dict, checked leaf for leaf against the port's model."""
    from ..models.xception import Xception65DeepLab   # the port's names

    middle, classes = _tree_geometry(variables)
    want = {k: tuple(t.shape) for k, t in Xception65DeepLab(
        num_classes=classes, middle_blocks=middle).state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            name = path[-1]
            leaf = np.asarray(leaf, np.float32)
            if name == "kernel":
                if leaf.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: a {leaf.ndim}-D "
                                     f"kernel; every Xception conv is 4-D")
                leaf, name = leaf.transpose(3, 2, 0, 1), "weight"
            key = ".".join(path[:-1] + (name,))
            if key not in want:
                raise ValueError(f"{collection}/{'/'.join(path)} has no "
                                 f"place in the port's Xception ({key})")
            if key in out:
                raise ValueError(f"{key} is filled twice")
            if tuple(leaf.shape) != want[key]:
                raise ValueError(f"{key}: shape {tuple(leaf.shape)}, the "
                                 f"port's is {want[key]}")
            out[key] = torch.tensor(np.ascontiguousarray(leaf))
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"the tree leaves {len(missing)} of the port's "
                         f"Xception tensors unfilled: {missing[:8]}")
    return out


def random_xception_variables(seed: int = 0, middle_blocks: int = 16,
                              num_classes: int = 15) -> dict:
    """A Flax-layout Xception-65 DeepLab variable tree of numpy arrays,
    made from ``seed``: LeCun-normal kernels, non-trivial BatchNorm
    scales, biases and statistics, so that every parameter matters.  The
    middle flow's identity skips carry the signal through the 65 layers:
    a seeded engine's logits still tell pixels apart (several classes
    win on synthetic frames)."""
    from ..models.xception import Xception65DeepLab

    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}
    model = Xception65DeepLab(num_classes=num_classes,
                              middle_blocks=middle_blocks)
    for key, t in model.state_dict().items():
        path = key.split(".")
        shape = tuple(t.shape)
        tree = params
        if path[-1] == "weight":     # OIHW → HWIO
            kshape = (shape[2], shape[3], shape[1], shape[0])
            fan_in = int(np.prod(kshape[:-1]))
            leaf = rng.standard_normal(kshape) / np.sqrt(fan_in)
            path[-1] = "kernel"
        elif path[-1] in ("mean", "var"):
            leaf = (rng.uniform(-0.2, 0.2, shape) if path[-1] == "mean"
                    else rng.uniform(0.5, 1.5, shape))
            tree = stats
        elif path[-1] == "scale":
            leaf = rng.uniform(0.7, 1.3, shape)
        else:   # conv / BatchNorm bias
            leaf = rng.uniform(-0.1, 0.1, shape)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf.astype(np.float32)
    return {"params": params, "batch_stats": stats}


__all__ = ["xception_state_dict", "random_xception_variables"]
