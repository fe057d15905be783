"""Spatial partitioning: one frame's rows split over the ranks of an axis.

Port of ``bugcar_image_segmentation_tpu/parallel/spatial.py``.  Data and
camera parallelism (``mesh.py``, ``multicam.py``) scale throughput, not
the latency of one frame; for that the JAX package shards the backbone
input's rows over a "space" mesh axis and lets GSPMD insert the halo
exchanges.  Here the weights are replicated, every rank preprocesses the
whole frame (the JAX program constrains the input after
``models/preprocess``), takes its rows, and runs the backbone with every
row-coupled layer exchanging halos over the axis (``halo.py``): the
convs, ENet's transposed conv, DeepLab's image pooling (a sum of the
shards' rows), the bilinear resizes, and SegFormer's attention, whose
queries stay the shard's while its spatially reduced K/V tokens are
gathered from every shard.  The uint8 labels (or, for
``Engine.logits``, the logits) are then gathered, so that every rank
returns the whole map, and a ``Pipeline`` built on the engine builds the
same grid on every rank.

The JAX package's rules, with its messages: the input height must divide
the axis; ``enet_fused`` and the ``_fs`` engines are refused (their
kernels are not partitioned); SegFormer needs its deepest stage's rows
(``input_height/32``) to divide the axis, and is served through its plain
attention with the cascade head (``_hc``) dropped.  Stricter than JAX:
where a stage's shard would not divide its stride the engine is refused
(GSPMD would pad).
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .halo import RowShards, install_rows
from .mesh import Mesh, replicate

# rows of the input per row of each family's deepest stage
DEEPEST = {"enet": 8, "unet": 16, "deeplab": 16, "xception": 16,
           "segformer": 32}


def shard_engine_spatial(engine, mesh: Mesh, axis: str = "space"):
    """Serve an :class:`~..models.api.Engine` with each frame's rows split
    over ``axis``; rank 0's weights on every rank of the axis.  The
    placement is the engine's ``placer``, so that ``load_variables`` keeps
    it.  Returns the engine; its labels are the unsharded engine's.  An
    axis of one rank splits nothing: the engine is checked and (SegFormer)
    switched to its plain attention as over several, and runs unsharded."""
    size = mesh.size(axis)
    height = engine.cfg.input_height
    if height % size:
        raise ValueError(
            f"input height {height} does not divide the '{axis}' mesh axis "
            f"({size}); pick a mesh the rows split evenly over")
    if engine.base_name == "enet_fused":
        raise ValueError(
            "enet_fused cannot be spatially partitioned (its kernel has no "
            "partitioning rule); use the stock 'enet' engine")
    if getattr(engine.module, "fused_sepconv", False):
        raise ValueError(
            "fused-sepconv (_fs) engines cannot be spatially partitioned; "
            "use the stock engine (identical weights)")
    if engine.family == "segformer" and (height // 32) % size:
        raise ValueError(
            f"SegFormer spatial partitioning needs the deepest stage's rows "
            f"(input_height/32 = {height // 32}) to divide the '{axis}' mesh "
            f"axis ({size})")
    deepest = DEEPEST[engine.family]
    if (height // size) % deepest:
        raise ValueError(
            f"{engine.name} spatial partitioning needs every stage's rows "
            f"to split evenly: input_height/{deepest} = {height // deepest} "
            f"does not divide the '{axis}' mesh axis ({size})")
    rows = (RowShards(mesh.group(axis), size, mesh.index(axis),
                      engine.device) if size > 1 else None)

    def place(eng) -> None:
        module = eng.module
        if eng.family == "segformer":
            # the plain attention; the head without the cascade
            module.xla_attention = True
            module.head_cascade = False
            module.folded_head = module.quant
            module.clear()
        replicate(module, mesh, axis)
        install_rows(module, rows)

    engine.spatial = rows
    engine.placer = place
    place(engine)
    return engine


def shard_batch_spatial(batch: Any, mesh: Mesh, axis: str = "space",
                        data_axis: str = "data") -> Any:
    """This rank's part of a training batch for a spatial train step:
    every leaf (images ``(N, H, W, C)``, labels ``(N, H, W)``) split by its
    rows (axis 1) over ``axis`` and, when the mesh has ``data_axis``, by its
    samples (axis 0) over that, as tensors on the mesh's device."""
    if isinstance(batch, Mapping):
        return {k: shard_batch_spatial(v, mesh, axis, data_axis)
                for k, v in batch.items()}
    if isinstance(batch, (list, tuple)):
        return type(batch)(shard_batch_spatial(v, mesh, axis, data_axis)
                           for v in batch)
    x = torch.as_tensor(batch if isinstance(batch, torch.Tensor)
                        else np.asarray(batch))
    if x.dim() < 2:
        raise ValueError(f"spatial batch leaves need a (N, H, ...) rank-2+ "
                         f"shape, got {tuple(x.shape)}")
    for dim, ax in ((0, data_axis), (1, axis)):
        n, size = x.shape[dim], mesh.size(ax)
        if n % size:
            raise ValueError(f"axis {dim} of {n} does not divide over the "
                             f"'{ax}' mesh axis ({size})")
        x = x.narrow(dim, mesh.index(ax) * (n // size), n // size)
    return x.contiguous().to(mesh.device)


__all__ = ["shard_engine_spatial", "shard_batch_spatial", "DEEPEST"]
