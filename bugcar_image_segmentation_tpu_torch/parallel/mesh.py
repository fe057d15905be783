"""Data parallelism on ``torch.distributed``.

Port of ``bugcar_image_segmentation_tpu/parallel/mesh.py`` for its "data"
axis.  The JAX package shards the batch over a device mesh and lets XLA
insert the gradient sum; here each rank is one process with one device,
and the train step (``training/trainer.make_train_step(..., mesh=)``)
makes the collectives itself, so that its result is the single-process
step's over the whole batch:

- each BatchNorm's per-channel sums of x and x² and their count are summed
  over the ranks before the statistics are taken (differentiably:
  ``torch.distributed.nn.functional.all_reduce``, whose backward sums the
  gradients), so the statistics are the global batch's;
- the loss's numerator and denominator are summed, so ignore labels or
  class weights that fall unevenly on the shards weigh as in the whole
  batch;
- the gradients of ``num_r / den_global`` are summed (one flat buffer).

A process group needs its address, world size and rank: ``torchrun``
gives them in the environment (``init_method="env://"``, the default), a
test passes ``tcp://localhost:<port>`` and both numbers.  gloo on the CPU,
NCCL on the card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Any, List, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.nn import functional as dist_nn


@dataclasses.dataclass(frozen=True)
class Mesh:
    """This process's place in a data-parallel group: its ``rank`` among
    ``world_size`` ranks and the ``device`` it computes on."""

    rank: int
    world_size: int
    device: torch.device

    def sum_moments(self, moments: torch.Tensor, n: int
                    ) -> Tuple[torch.Tensor, int]:
        """A BatchNorm's (2, C) sums of x and x² and their count, summed
        over the ranks (shards are equal, so the count is n * world)."""
        return dist_nn.all_reduce(moments), n * self.world_size

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor, no gradient)."""
        t = t.detach().clone()
        dist.all_reduce(t)
        return t

    @torch.no_grad()
    def all_reduce_grads(self, params: List[torch.Tensor]) -> None:
        """Replace each parameter's ``.grad`` by its sum over the ranks."""
        grads = [p.grad for p in params]
        flat = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()

    def close(self) -> None:
        """Leave the process group."""
        if dist.is_initialized():
            dist.destroy_process_group()


def make_mesh(n_devices: Optional[int] = None, device: str = "cuda",
              init_method: str = "env://", rank: Optional[int] = None,
              timeout_s: float = 300.0) -> Mesh:
    """Join (or create) the process group of ``n_devices`` ranks.

    ``n_devices`` and ``rank`` default to ``torchrun``'s ``WORLD_SIZE`` and
    ``RANK``.  ``device`` "cuda" uses NCCL and the card ``LOCAL_RANK``
    (default: the rank); "cpu" uses gloo.  ``timeout_s`` bounds every
    collective, so a rank that never arrives fails the others."""
    env = os.environ
    world = int(n_devices if n_devices is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    if device == "cuda":
        dev = torch.device("cuda", int(env.get("LOCAL_RANK", rank)))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"device must be 'cuda' or 'cpu', got {device!r}")
    if not dist.is_initialized():
        dist.init_process_group(
            backend, init_method=init_method, world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    if (dist.get_world_size(), dist.get_rank()) != (world, rank):
        raise ValueError(f"the process group has rank {dist.get_rank()} of "
                         f"{dist.get_world_size()}, not {rank} of {world}")
    return Mesh(rank, world, dev)


def shard_batch(batch: Any, mesh: Mesh) -> Any:
    """This rank's slice of every array in ``batch`` (a tensor, a numpy
    array, or a tuple / list / dict of them) along the leading axis, as
    tensors on the mesh's device; the leading axis must divide by the
    world size."""
    if isinstance(batch, Mapping):
        return {k: shard_batch(v, mesh) for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch(v, mesh) for v in batch)
    x = torch.as_tensor(np.asarray(batch) if not isinstance(
        batch, torch.Tensor) else batch)
    n = x.shape[0]
    if n % mesh.world_size:
        raise ValueError(f"a leading axis of {n} does not divide over "
                         f"{mesh.world_size} ranks")
    per = n // mesh.world_size
    return x[mesh.rank * per:(mesh.rank + 1) * per].to(mesh.device)


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
def replicate(tree: Any, mesh: Mesh) -> Any:
    """Rank 0's values of every tensor in ``tree`` (a module, a
    TrainState, or a dict / list / dataclass of tensors), broadcast in
    place to every rank; returns ``tree``."""
    del mesh    # the default group
    for t in _tensors(tree):
        dist.broadcast(t, src=0)
    return tree


__all__ = ["Mesh", "make_mesh", "shard_batch", "replicate"]
