"""A strict bridge from a Flax variable tree to a port module's
``state_dict``, and seeded Flax-layout trees for the card.

Takes the JAX package's ``{"params": ..., "batch_stats": ...}`` tree with
numpy leaves (float32 or bfloat16, as the committed checkpoints store
them) and returns float32 tensors keyed as the port's module names them:

- conv ``kernel`` (HWIO) → ``weight`` (OIHW): a depthwise (3, 3, 1, C) →
  (C, 1, 3, 3), a pointwise (1, 1, C, F) → (F, C, 1, 1);
- a transposed conv's ``kernel`` (Flax: HWIO, applied unflipped over the
  dilated input) → ``weight`` in ``conv_transpose2d`` layout (in, out, kh,
  kw), spatially flipped;
- ``bias``, BatchNorm ``scale``/``bias`` as they are, BatchNorm running
  ``mean``/``var`` (``batch_stats``) → buffers.

Every leaf is consumed exactly once: a leaf the module has no place for, a
place no leaf fills, or a shape that does not fit raises ``ValueError``.
Pure numpy + torch; the caller restores the tree.

:func:`flax_variables` is the inverse, for a trained port model going back
to a Flax checkpoint (``utils/checkpoint.save_variables``): every bridge
in this package maps its result back onto the tree it came from, leaf for
leaf and bit for bit.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence, Set

import numpy as np
import torch
import torch.nn as nn

from .flax_enet import _leaves


def strict_state_dict(variables: Mapping, model: nn.Module,
                      transposed: Sequence[str] = ()
                      ) -> Dict[str, torch.Tensor]:
    """Flax variable tree (numpy leaves) → ``model``'s state dict, checked
    leaf for leaf against it; ``transposed`` names the modules whose
    kernels are transposed convs (by their last name or their whole
    dotted one).  A 2-D kernel fills a Dense's 2-D weight, (in, out) →
    (out, in)."""
    what = type(model).__name__
    want = {k: tuple(t.shape) for k, t in model.state_dict().items()}
    out: Dict[str, torch.Tensor] = {}
    for collection in ("params", "batch_stats"):
        for path, leaf in _leaves(variables.get(collection, {})):
            name = path[-1]
            leaf = np.asarray(leaf, np.float32)
            if name == "kernel":
                dense = len(want.get(".".join(path[:-1] + ("weight",)),
                                     ())) == 2
                if dense and leaf.ndim == 2:
                    leaf = leaf.T
                elif leaf.ndim != 4:
                    raise ValueError(f"{'/'.join(path)}: a {leaf.ndim}-D "
                                     f"kernel; every {what} conv is 4-D")
                elif (path[-2] in transposed
                      or ".".join(path[:-1]) in transposed):
                    leaf = np.flip(leaf, (0, 1)).transpose(2, 3, 0, 1)
                else:
                    leaf = leaf.transpose(3, 2, 0, 1)
                name = "weight"
            key = ".".join(path[:-1] + (name,))
            if key not in want:
                raise ValueError(f"{collection}/{'/'.join(path)} has no "
                                 f"place in the port's {what} ({key})")
            if key in out:
                raise ValueError(f"{key} is filled twice")
            if tuple(leaf.shape) != want[key]:
                raise ValueError(f"{key}: shape {tuple(leaf.shape)}, the "
                                 f"port's is {want[key]}")
            out[key] = torch.tensor(np.ascontiguousarray(leaf))
    missing = sorted(set(want) - set(out))
    if missing:
        raise ValueError(f"the tree leaves {len(missing)} of the port's "
                         f"{what} tensors unfilled: {missing[:8]}")
    return out


def random_variables(model: nn.Module, seed: int = 0,
                     transposed: Sequence[str] = ()) -> dict:
    """A Flax-layout variable tree of numpy arrays for ``model``'s state
    dict, made from ``seed``: LeCun-normal kernels, non-trivial norm
    scales, biases and BatchNorm statistics, so that every parameter
    matters."""
    rng = np.random.default_rng(seed)
    params: dict = {}
    stats: dict = {}
    for key, t in model.state_dict().items():
        path = key.split(".")
        shape = tuple(t.shape)
        tree = params
        if path[-1] == "weight":     # back to the Flax kernel's layout
            if len(shape) == 2:     # Dense: (out, in) → (in, out)
                kshape = (shape[1], shape[0])
            elif path[-2] in transposed:
                kshape = (shape[2], shape[3], shape[0], shape[1])
            else:                   # OIHW → HWIO
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
        else:   # Dense / conv / norm bias
            leaf = rng.uniform(-0.1, 0.1, shape)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = leaf.astype(np.float32)
    return {"params": params, "batch_stats": stats}


def flax_variables(model: nn.Module) -> dict:
    """The port model's state dict → its Flax variable tree (``params`` and
    ``batch_stats``) of float32 numpy arrays: ``weight`` → ``kernel``
    (OIHW → HWIO; a transposed conv's (in, out, kh, kw) → the Flax kernel,
    flipped back; a Dense's (out, in) → (in, out)), BatchNorm ``mean`` /
    ``var`` → ``batch_stats``, every other leaf as it is.  The transposed
    convs are the port's ``ConvTranspose`` (ENet) and ``UpConv2x`` (UNet)
    modules."""
    transposed = transposed_modules(model)
    params: dict = {}
    stats: dict = {}
    for key, t in model.state_dict().items():
        path = key.split(".")
        leaf = t.detach().float().cpu().numpy()
        tree = stats if path[-1] in ("mean", "var") else params
        if path[-1] == "weight":
            if leaf.ndim == 2:
                leaf = leaf.T
            elif ".".join(path[:-1]) in transposed:
                leaf = np.flip(leaf.transpose(2, 3, 0, 1), (0, 1))
            else:
                leaf = leaf.transpose(2, 3, 1, 0)
            path[-1] = "kernel"
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(leaf, np.float32, order="C")   # a copy
    out = {"params": params}
    if stats:
        out["batch_stats"] = stats
    return out


def transposed_modules(model: nn.Module) -> Set[str]:
    """The dotted names of ``model``'s transposed convs: the port's
    ``ConvTranspose`` (ENet) and ``UpConv2x`` (UNet) modules."""
    from ..models.enet import ConvTranspose
    from ..models.unet import UpConv2x

    return {name for name, m in model.named_modules()
            if isinstance(m, (ConvTranspose, UpConv2x))}


def module_state_dict(variables: Mapping, model: nn.Module
                      ) -> Dict[str, torch.Tensor]:
    """:func:`flax_variables`'s inverse for any port model: its Flax tree
    → its state dict, strictly (:func:`strict_state_dict`)."""
    return strict_state_dict(variables, model, transposed_modules(model))


def classifier_width(variables: Mapping, what: str) -> int:
    """The classes of a segmentation tree: its classifier's width; ``what``
    names the tree in the error ("an Xception-65 DeepLab")."""
    try:
        return int(np.shape(variables["params"]["classifier"]["kernel"])[-1])
    except KeyError as exc:
        raise ValueError(f"not {what} tree: no params/classifier/kernel"
                         ) from exc


__all__ = ["strict_state_dict", "random_variables", "flax_variables",
           "transposed_modules", "module_state_dict",
           "classifier_width"]
