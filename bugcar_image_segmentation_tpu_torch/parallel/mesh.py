"""Device meshes on ``torch.distributed``: named axes over the ranks.

Port of ``bugcar_image_segmentation_tpu/parallel/mesh.py``.  The JAX
package builds a named device mesh and lets XLA insert the collectives;
here each rank is one process with one device, and a :class:`Mesh` names
its axes ("data", "model", "space") and holds one process group per axis
line, so that every collective of a parallel path is scoped to its axis.
Ranks lie on the mesh row-major, as ``make_mesh`` lays devices out in the
JAX package: rank ``r`` of a (2, 4) mesh sits at ``divmod(r, 4)``.

The train step (``training/trainer.make_train_step(..., mesh=)``) makes
its collectives itself, so that its result is the single-process step's
over the whole batch:

- each BatchNorm's per-channel sums of x and x² and their count are summed
  over the batch axes ("data" and "space") before the statistics are taken
  (differentiably: ``torch.distributed.nn.functional.all_reduce``, whose
  backward sums the gradients), so the statistics are the global batch's;
- the loss's numerator and denominator are summed over the same axes, so
  ignore labels or class weights that fall unevenly on the shards weigh as
  in the whole batch;
- the gradients of ``num_r / den_global`` are summed over them (one flat
  buffer).  A "model" axis (``tp.py``) is not summed over: its ranks see
  the same samples, and each holds its slices' gradients whole.

A process group needs its address, world size and rank: ``torchrun``
gives them in the environment (``init_method="env://"``, the default), a
test passes ``tcp://localhost:<port>`` and both numbers.  gloo on the CPU,
NCCL on the card; ``backend="gloo"`` on the card runs several ranks on one
card, which NCCL refuses.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.nn import functional as dist_nn

BATCH_AXES = ("data", "space")   # the axes a batch's samples and rows split


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place on a mesh of ``world_size`` ranks: its
    ``rank``, the ``device`` it computes on, the mesh's ``shape`` and
    ``axis_names`` (default: one "data" axis over every rank), and per axis
    the process group of its line (absent for an axis over every rank,
    whose group is the default one)."""

    rank: int
    world_size: int
    device: torch.device
    shape: Tuple[int, ...] = ()
    axis_names: Tuple[str, ...] = ("data",)
    groups: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        if not self.shape:
            object.__setattr__(self, "shape", (self.world_size,))
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} does not name its "
                             f"axes {self.axis_names}")
        if math.prod(self.shape) != self.world_size:
            raise ValueError(f"mesh shape {self.shape} != {self.world_size} "
                             f"ranks")

    def __deepcopy__(self, memo):
        return self     # process groups are the process's, not copied

    @property
    def axis_sizes(self) -> Dict[str, int]:
        """{axis: size}, as the JAX mesh's ``shape``."""
        return dict(zip(self.axis_names, self.shape))

    def size(self, axis: str) -> int:
        """Ranks along ``axis`` (1 for an axis the mesh does not have)."""
        return self.axis_sizes.get(axis, 1)

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis`` (0 if absent)."""
        if axis not in self.axis_names:
            return 0
        coords = np.unravel_index(self.rank, self.shape)
        return int(coords[self.axis_names.index(axis)])

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        if axis not in self.axis_names:
            raise ValueError(f"the mesh has axes {self.axis_names}, not "
                             f"{axis!r}")
        if self.size(axis) == self.world_size:
            return dist.group.WORLD
        if axis not in self.groups:
            raise ValueError(f"the mesh holds no process group for its "
                             f"{axis!r} axis; build it with make_mesh")
        return self.groups[axis]

    @property
    def batch_axes(self) -> Tuple[str, ...]:
        """The axes over which a batch's samples or rows are split, and a
        train step's sums are taken."""
        return tuple(a for a in self.axis_names
                     if a in BATCH_AXES and self.size(a) > 1)

    def _batch_groups(self) -> List[Any]:
        """The groups a sum over the batch axes runs in: the default group
        when they hold every rank, else one per axis in turn."""
        axes = self.batch_axes
        if math.prod(self.size(a) for a in axes) == self.world_size > 1:
            return [dist.group.WORLD]
        return [self.group(a) for a in axes]

    def sum_moments(self, moments: torch.Tensor, n: int
                    ) -> Tuple[torch.Tensor, int]:
        """A BatchNorm's (2, C) sums of x and x² and their count, summed
        over the batch axes (shards are equal, so the count is n times
        their size)."""
        for g in self._batch_groups():
            moments = dist_nn.all_reduce(moments, group=g)
        return moments, n * math.prod(self.size(a) for a in self.batch_axes)

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the batch axes, a new tensor with no
        gradient."""
        t = t.detach().clone()
        for g in self._batch_groups():
            dist.all_reduce(t, group=g)
        return t

    @torch.no_grad()
    def all_reduce_grads(self, params: List[torch.Tensor]) -> None:
        """Replace each parameter's ``.grad`` by its sum over the batch
        axes."""
        groups = self._batch_groups()
        if not groups:
            return
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        for g in groups:
            dist.all_reduce(flat, group=g)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def close(self) -> None:
        """Leave the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def _axis_groups(shape: Tuple[int, ...], axes: Tuple[str, ...], rank: int
                 ) -> Dict[str, Any]:
    """One process group per line of every axis that is not the whole
    world (a line of one rank too, so that no collective of an axis of
    size 1 runs over the default group); every rank creates every group,
    in one order, as ``new_group`` requires."""
    grid = np.arange(math.prod(shape)).reshape(shape)
    groups: Dict[str, Any] = {}
    for i, axis in enumerate(axes):
        if shape[i] == grid.size:
            continue
        for line in np.moveaxis(grid, i, -1).reshape(-1, shape[i]):
            g = dist.new_group([int(r) for r in line])
            if rank in line:
                groups[axis] = g
    return groups


def make_mesh(n_devices: Optional[int] = None,
              axes: Tuple[str, ...] = ("data",),
              shape: Optional[Tuple[int, ...]] = None,
              device: str = "cuda", init_method: str = "env://",
              rank: Optional[int] = None, timeout_s: float = 300.0,
              backend: Optional[str] = None) -> Mesh:
    """Join (or create) the process group of ``n_devices`` ranks and lay
    them on a mesh with named ``axes``.

    ``n_devices`` and ``rank`` default to ``torchrun``'s ``WORLD_SIZE`` and
    ``RANK``; ``shape`` defaults to every rank on the first axis.  ``device``
    "cuda" computes on the card ``LOCAL_RANK`` (default: the rank) over NCCL
    unless ``backend`` says otherwise; "cpu" uses gloo.  ``timeout_s``
    bounds every collective, so a rank that never arrives fails the
    others."""
    env = os.environ
    world = int(n_devices if n_devices is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    axes = tuple(axes)
    if shape is None:
        shape = (world,) + (1,) * (len(axes) - 1)
    shape = tuple(int(s) for s in shape)
    if math.prod(shape) != world or len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} over axes {axes} != {world} "
                         f"devices")
    if device == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
        backend = backend or "nccl"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), backend or "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    if (dist.get_world_size(), dist.get_rank()) != (world, rank):
        raise ValueError(f"the process group has rank {dist.get_rank()} of "
                         f"{dist.get_world_size()}, not {rank} of {world}")
    return Mesh(rank, world, dev, shape, axes,
                _axis_groups(shape, axes, rank))


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's slice of every array in ``batch`` (a tensor, a numpy
    array, or a tuple / list / dict of them) along the leading axis, by
    its coordinate on the "data" axis (a mesh without one gives every
    rank the whole batch), as tensors on the mesh's device; the leading
    axis must divide by the axis's size."""
    if isinstance(batch, Mapping):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    x = torch.as_tensor(np.asarray(batch) if not isinstance(
        batch, torch.Tensor) else batch)
    n, size = x.shape[0], mesh.size("data")
    if n % size:
        raise ValueError(f"a leading axis of {n} does not divide over "
                         f"{size} ranks")
    per, i = n // size, mesh.index("data")
    return x[i * per:(i + 1) * per].to(mesh.device)


def _tensors(tree: Any) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, Mapping):
        return [t for v in tree.values() for t in _tensors(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in _tensors(v)]
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return [t for f in dataclasses.fields(tree)
                for t in _tensors(getattr(tree, f.name))]
    return []


@torch.no_grad()
def replicate(tree: Any, mesh: Mesh, axis: Optional[str] = None) -> Any:
    """Rank 0's values of every tensor in ``tree`` (a module, a
    TrainState, or a dict / list / dataclass of tensors), broadcast in
    place to every rank, or along ``axis`` from the line's first rank;
    returns ``tree``."""
    if axis is not None and mesh.size(axis) == 1:
        return tree
    group = None if axis is None else mesh.group(axis)
    src = 0 if group is None else dist.get_global_rank(group, 0)
    for t in _tensors(tree):
        dist.broadcast(t, src=src, group=group)
    return tree


__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate", "BATCH_AXES"]
