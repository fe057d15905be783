"""Tensor parallelism: wide layers' output channels over a "model" axis.

Port of ``bugcar_image_segmentation_tpu/parallel/tp.py``.  The JAX package
places a parameter leaf channel-sharded over the "model" mesh axis when
its output-channel axis is wide enough and divides (:func:`tp_spec_for`),
and GSPMD derives the collectives.  Here a rank holds such a leaf as its
slice (1/tp of it), and the modules that own sliced leaves make the
collectives themselves:

- a conv, dense or transposed conv whose kernel is sliced runs
  column-parallel: it computes its local output channels (and adds its
  local bias), then all-gathers them over the model axis, since the next
  layer needs every channel.  In the backward the gather takes the local
  slice of the output's gradient (the layers after it are replicated, so
  every rank holds the same gradient; a reduce-scatter sum would scale it
  by tp), and the layer's input sums its gradient over the axis (each
  rank saw its own output channels only);
- a per-channel layer (BatchNorm, PReLU) whose leaves are sliced runs on
  its local channels of its input and gathers its output the same way, so
  that its batch statistics and running averages are its slice's;
- any other layer that owns a sliced leaf (a LayerNorm, a depthwise conv,
  a ``fused_bottleneck`` block's kernel arguments) gathers the leaf before
  use, as GSPMD does for an operation without a partitioning rule: the
  fused kernel runs whole, on every rank, with whole weights.

Leaves that do not clear the rule stay whole (replicated), so the
transform is always safe; the model's outputs are the unsharded model's.
A train step over a ("data", "model") mesh sums gradients over "data"
only (``mesh.py``): each rank holds its slices' gradients whole.
"""

from __future__ import annotations

import types
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from .mesh import Mesh, replicate

# Flax leaf names whose only axis shards (tp_spec_for); ``mul`` / ``add``
# are the port's folded ENet BatchNorm constants, which are not Flax leaves
# and follow their BatchNorm's ``scale``.
PER_CHANNEL = ("bias", "scale", "alpha", "mean", "var")
FOLDED = ("mul", "add")


def tp_spec_for(path: Tuple[str, ...], shape: Tuple[int, ...], size: int,
                min_channels: int = 64) -> Optional[int]:
    """The axis of a Flax leaf (``path`` in the variable tree, ``shape`` in
    Flax layout) that JAX's ``tp_spec_for`` shards over a model axis of
    ``size`` ranks, or None (replicated).

    Conv kernels (H, W, I, O) and dense kernels (I, O) shard their output
    channels when there are at least ``min_channels`` and they divide;
    biases, norm scales, PReLU slopes and BatchNorm statistics shard their
    only axis under the same condition; everything else replicates."""
    name = path[-1] if path else ""
    if name == "kernel" and len(shape) >= 2:
        out_ch = shape[-1]
        if out_ch >= min_channels and out_ch % size == 0:
            return len(shape) - 1
    elif name in PER_CHANNEL and len(shape) == 1:
        if shape[0] >= min_channels and shape[0] % size == 0:
            return 0
    return None


class ModelAxis:
    """This rank's place on the model axis: its group, size and index."""

    def __init__(self, mesh: Mesh, axis: str = "model"):
        self.group, self.size = mesh.group(axis), mesh.size(axis)
        self.index = mesh.index(axis)

    def __deepcopy__(self, memo):
        return self     # holds a process group: shared, never copied

    def local(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's slice of the whole ``t`` along ``dim``."""
        return t.chunk(self.size, dim)[self.index]

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every rank's slice along ``dim``; its
        backward takes this rank's slice of the gradient."""
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x.detach().contiguous(), group=self.group)
        if torch.is_grad_enabled() and x.requires_grad:
            parts[self.index] = x
        return torch.cat(parts, dim)

    def sum_grad(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` whose gradient is summed over the axis in the backward."""
        if not (torch.is_grad_enabled() and x.requires_grad):
            return x
        group = self.group

        def all_reduce(g: torch.Tensor) -> torch.Tensor:
            g = g.clone()
            dist.all_reduce(g, group=group)
            return g

        y = x.view_as(x)
        y.register_hook(all_reduce)
        return y


def _column_methods(mod: nn.Module) -> Optional[Dict[str, int]]:
    """The compute methods of a layer that can run column-parallel, each
    with its output's channel axis, or None."""
    from ..models import enet, layers, segformer, unet
    if isinstance(mod, (enet.Conv, enet.ConvTranspose)):
        return {"forward": 1}
    if isinstance(mod, layers.Conv) and mod.groups == 1 or isinstance(
            mod, (unet.UpConv2x, segformer.Pointwise)):
        return {"forward": -1}
    if isinstance(mod, segformer.Dense):
        return {"forward": -1, "forward_t": 1, "from_t": -1}
    return None


def _channel_dim(mod: nn.Module) -> Optional[int]:
    """The channel axis of a per-channel layer's input, or None."""
    from ..models import enet, layers
    if isinstance(mod, enet.PReLU):
        return 1
    if isinstance(mod, layers.BatchNorm):      # ENet's too (axis 1)
        return mod.channel_dim
    return None


def _column(method: str, out_dim: int):
    def forward(self, x, *args, **kwargs):
        ax = self._tp_axis
        y = getattr(type(self), method)(self, ax.sum_grad(x), *args, **kwargs)
        return ax.gather(y, out_dim)
    return forward


def _channelwise(dim: int):
    def forward(self, x, *args, **kwargs):
        ax = self._tp_axis
        y = type(self).forward(self, ax.local(ax.sum_grad(x), dim),
                               *args, **kwargs)
        return ax.gather(y, dim)
    return forward


def _gather_leaves(self, *args, **kwargs):
    """Run the layer's forward with its sliced leaves gathered whole."""
    ax, saved = self._tp_axis, {}
    for name, dim in self._tp_leaves.items():
        store = self._parameters if name in self._parameters else \
            self._buffers
        saved[name] = (store, store[name])
        store[name] = ax.gather(store[name], dim)
    try:
        return type(self).forward(self, *args, **kwargs)
    finally:
        for name, (store, t) in saved.items():
            store[name] = t


def _flax_leaf(prefix: str, name: str, t: torch.Tensor, transposed: bool
               ) -> Tuple[Tuple[str, ...], Tuple[int, ...], int]:
    """A port leaf → (its Flax path, its Flax shape, the port axis that
    holds the Flax leaf's last axis)."""
    path = tuple(prefix.split(".")) if prefix else ()
    shape = tuple(t.shape)
    if name == "weight":
        if len(shape) == 2:                       # Dense (out, in)
            return path + ("kernel",), shape[::-1], 0
        if transposed:                            # (in, out, kh, kw)
            return (path + ("kernel",),
                    (shape[2], shape[3], shape[0], shape[1]), 1)
        return (path + ("kernel",),               # OIHW → HWIO
                (shape[2], shape[3], shape[1], shape[0]), 0)
    return path + (name,), shape, 0


def _slice(mod: nn.Module, leaves: Dict[str, int], ax: ModelAxis) -> None:
    """Hold ``mod``'s ``leaves`` (name → axis) as this rank's slices and
    route its forward as the module docstring says."""
    for name, dim in leaves.items():
        if name in mod._parameters:
            p = mod._parameters[name]
            mod._parameters[name] = nn.Parameter(
                ax.local(p.detach(), dim).clone(), p.requires_grad)
        else:
            mod._buffers[name] = ax.local(mod._buffers[name], dim).clone()
    mod._tp_axis, mod._tp_leaves = ax, dict(leaves)
    column = _column_methods(mod)
    if column is not None and "weight" in leaves:
        for method, out_dim in column.items():
            setattr(mod, method, types.MethodType(_column(method, out_dim),
                                                  mod))
    elif _channel_dim(mod) is not None:
        mod.forward = types.MethodType(_channelwise(_channel_dim(mod)), mod)
    else:
        mod.forward = types.MethodType(_gather_leaves, mod)


def shard_params_tp(model, mesh: Mesh, axis: str = "model",
                    min_channels: int = 64):
    """Slice a model's channel-wide leaves over ``axis`` in place.

    ``model``: a port module (its leaves decided by :func:`tp_spec_for` on
    their Flax paths and shapes), or a ``TrainState`` (its model, and the
    optimizer's per-parameter state sliced alike).  Every rank must hold
    the same values before (``replicate``).  Returns ``model``."""
    from ..models.enet import ConvTranspose
    from ..models.unet import UpConv2x
    from ..training.trainer import TrainState

    if isinstance(model, TrainState):
        shard_params_tp(model.model, mesh, axis, min_channels)
        _slice_optimizer(model)
        return model
    ax = ModelAxis(mesh, axis)
    if ax.size == 1:
        return model
    for prefix, mod in model.named_modules():
        if hasattr(mod, "_tp_axis"):
            raise ValueError(f"{prefix or 'the model'} is sliced already")
        transposed = isinstance(mod, (ConvTranspose, UpConv2x))
        leaves = {}
        for name, t in list(mod._parameters.items()) + list(
                mod._buffers.items()):
            if t is None:
                continue
            if name in FOLDED:      # follows its BatchNorm's scale
                path, shape, dim = ("scale",), tuple(t.shape), 0
            else:
                path, shape, dim = _flax_leaf(prefix, name, t, transposed)
            if tp_spec_for(path, shape, ax.size, min_channels) is not None:
                leaves[name] = dim
        if leaves:
            _slice(mod, leaves, ax)
    return model


def _slice_optimizer(state) -> None:
    """Slice an optimizer state's per-parameter tensors (AdamW's moments)
    as the model's parameters were sliced."""
    params = state.params
    for field in ("mu", "nu"):
        table = getattr(state.opt_state, field, {})
        for name, t in list(table.items()):
            if t.shape != params[name].shape:
                mod_name, _, leaf = name.rpartition(".")
                mod = state.model.get_submodule(mod_name)
                table[name] = mod._tp_axis.local(
                    t, mod._tp_leaves[leaf]).clone()


def _fused_blocks(engine):
    from ..models.enet_fused import FusedENet
    fn = engine.forward_fn
    return list(fn.blocks) if isinstance(fn, FusedENet) else []


def _shard_fused_block(block: nn.Module, ax: ModelAxis,
                       min_channels: int) -> None:
    """A ``fused_bottleneck`` block's kernel arguments (folded constants,
    squeezed kernels, the packed bf16 weights) held as slices of their
    leading axis where it divides, gathered whole before every launch."""
    leaves = {name: 0 for name, t in block._buffers.items()
              if t is not None and t.dim() >= 1
              and t.shape[0] >= min_channels and t.shape[0] % ax.size == 0}
    if leaves:
        _slice(block, leaves, ax)


def shard_engine_tp(engine, mesh: Mesh, axis: str = "model",
                    min_channels: int = 64):
    """Serve an :class:`~..models.api.Engine` tensor-parallel over
    ``axis``: rank 0's weights on every rank of the axis, then every
    channel-wide leaf sliced (:func:`shard_params_tp`; an ``enet_fused``
    engine's kernel arguments too).  The placement is installed as the
    engine's ``placer``, so that ``load_variables`` slices a new tree the
    same way.  Returns the engine; its labels are the unsharded engine's.
    SegFormer's folded head (``_hc``, ``_int8``) composes its Denses'
    weights whole outside their forwards, and is refused."""
    if getattr(engine.module, "folded_head", False):
        raise ValueError(
            f"{engine.name}: the folded SegFormer head (_hc / _int8) "
            f"cannot be served tensor-parallel; use the engine without "
            f"the flag")
    ax = ModelAxis(mesh, axis)

    def place(eng) -> None:
        replicate(eng.module, mesh, axis)
        for block in _fused_blocks(eng):
            replicate(block, mesh, axis)
            _shard_fused_block(block, ax, min_channels)
        shard_params_tp(eng.module, mesh, axis, min_channels)

    engine.placer = place
    place(engine)
    return engine


def whole_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """A sliced model's state dict with every slice gathered whole (the
    unsharded model's tensors)."""
    out = {}
    for prefix, mod in model.named_modules():
        leaves = getattr(mod, "_tp_leaves", {})
        for name, t in list(mod._parameters.items()) + [
                (n, b) for n, b in mod._buffers.items()
                if n not in mod._non_persistent_buffers_set]:
            if t is None:
                continue
            key = f"{prefix}.{name}" if prefix else name
            with torch.no_grad():
                out[key] = (mod._tp_axis.gather(t, leaves[name])
                            if name in leaves else t).detach().clone()
    return out


__all__ = ["tp_spec_for", "shard_params_tp", "shard_engine_tp",
           "whole_state_dict", "ModelAxis"]
