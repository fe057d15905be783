"""One frame's rows over the ranks of a process group: the halo exchange.

The JAX package's spatial partitioning (``parallel/spatial.py``) shards a
frame's rows over a mesh axis and lets GSPMD insert the halo exchanges
that every window crossing a shard edge needs.  Here the model's
row-coupled layers ask a :class:`RowShards` for them: a layer whose
``rows`` attribute is None (every single-device path) runs as before, with
no collective and no launch added.

Every exchange is one gather over the group, made as a sum: each rank
places its piece in a zero tensor of every rank's pieces, and an
``all_reduce`` adds them up.  One code serves eager calls, training (the
sum's backward sums each row's gradient over the ranks, and the placing
keeps this rank's rows) and ``torch.export`` (the functional
``all_reduce``, which a program exports with and which gloo runs on CUDA
tensors; the functional ``all_gather`` crashes there).  What a rank
contributes is its first and last ``k`` rows, ``k`` the widest halo asked
for; when the
halo is as wide as a shard or wider (a dilation-16 core over shards of one
row), the whole shard, so that a rank reads rows from every other rank and
not only from its neighbours.  Rows beyond the frame's true edges are
zeros (a conv's SAME padding) or the edge row repeated (a resize's clamped
index).

The rank's coordinate on the axis, :attr:`RowShards.index`, is a 0-d
tensor, and the rows each rank takes are read from tables indexed by it,
so that one exported program serves every rank (``deploy.py`` makes it an
input of the program).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.distributed._functional_collectives as funcol
from torch.distributed.nn import functional as dist_nn

from ..ops import device_cache


def wait(t: torch.Tensor) -> torch.Tensor:
    """A functional collective's result as a plain tensor (eagerly it is
    an ``AsyncCollectiveTensor``, which a kernel's data pointer must not
    be read from before the collective ends)."""
    return t.wait() if isinstance(t, funcol.AsyncCollectiveTensor) else t


def all_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group (backward: the sum of the
    gradients, which every rank then holds)."""
    if (torch.is_grad_enabled() and x.requires_grad
            and not torch.compiler.is_exporting()):
        return dist_nn.all_reduce(x, group=group)
    return wait(funcol.all_reduce(x, "sum", group))


def all_gather(x: torch.Tensor, dim: int, group,
               index: torch.Tensor) -> torch.Tensor:
    """The group's ``x`` concatenated along ``dim`` in rank order: ``x``
    placed by ``index`` (this rank's place in the group, a 0-d tensor) in
    a zero tensor of every rank's pieces, summed over the group.  Its
    backward gives each piece the sum of its gradient over the ranks."""
    dim %= x.dim()
    size = dist.get_world_size(group)
    whole = x.new_zeros((size,) + tuple(x.shape)).index_copy(
        0, index.view(1), x.contiguous()[None])
    whole = all_sum(whole, group)
    return whole.movedim(0, dim).flatten(dim, dim + 1)


@functools.lru_cache(maxsize=256)
def _halo_table(size: int, rows: int, k: int, lo: int, hi: int,
                replicate: bool) -> Tuple[np.ndarray, np.ndarray]:
    """Per rank, the position of each halo row (``lo`` above, ``hi`` below)
    in the gathered edges, and whether it lies inside the frame (or is
    repeated from its edge)."""
    width = rows if k == rows else 2 * k      # rows a rank contributes
    last = size * rows - 1

    def position(g: int) -> int:
        j, o = divmod(g, rows)
        if width == rows or o < k:
            return j * width + o
        return j * width + k + o - (rows - k)

    pos = np.zeros((size, lo + hi), np.int64)
    keep = np.zeros((size, lo + hi), bool)
    for r in range(size):
        need = (list(range(r * rows - lo, r * rows))
                + list(range((r + 1) * rows, (r + 1) * rows + hi)))
        for i, g in enumerate(need):
            pos[r, i] = position(min(max(g, 0), last))
            keep[r, i] = replicate or 0 <= g <= last
    return pos, keep


@functools.lru_cache(maxsize=128)
def _lerp_table(size: int, src: int, dst: int
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Half-pixel-centre bilinear taps of a shard's ``dst`` output rows in
    its ``src`` input rows extended by one row on each side: the global
    source index (``ops/resize._linear_axis``'s arithmetic on the whole
    axis, unclamped) less the shard's first row, plus 1, and the weight.
    They are the same on every rank when the shards split the axis
    evenly; a split that makes them differ is refused."""
    x = (np.arange(size * dst) + 0.5) * (size * src / (size * dst)) - 0.5
    x0 = np.floor(x).astype(np.int64)
    frac = (x - x0).astype(np.float32)
    rel = [x0[r * dst:(r + 1) * dst] - (r * src - 1) for r in range(size)]
    fr = [frac[r * dst:(r + 1) * dst] for r in range(size)]
    if any(not np.array_equal(rel[0], a) or not np.array_equal(fr[0], b)
           for a, b in zip(rel, fr)):
        raise ValueError(f"a bilinear resize of {size} x {src} rows to "
                         f"{size} x {dst} taps other rows on each shard")
    return rel[0], fr[0]


@device_cache(maxsize=256)
def _on_device(kind: str, args: tuple, device: torch.device):
    if kind == "halo":
        pos, keep = _halo_table(*args)
        return (torch.as_tensor(pos, device=device),
                torch.as_tensor(keep, device=device))
    rel, frac = _lerp_table(*args)
    return (torch.as_tensor(rel, device=device),
            torch.as_tensor(rel + 1, device=device),
            torch.as_tensor(frac, device=device))


class RowShards:
    """A frame's rows split evenly over the ``size`` ranks of ``group``;
    this rank holds the shard at :attr:`index` (a 0-d int64 tensor on the
    device, set for a call with :meth:`at`).

    Set on a model by ``parallel/spatial.py`` (``rows`` attributes), its
    methods are what the row-coupled layers call: :meth:`conv_rows`,
    :meth:`halo`, :meth:`lerp_rows`, :meth:`gather`, :meth:`sum`."""

    def __init__(self, group, size: int, index: int, device):
        self.group, self.size = group, int(size)
        self.index = torch.tensor(int(index), dtype=torch.int64,
                                  device=device)

    def __deepcopy__(self, memo):
        return self     # holds a process group: shared, never copied

    @contextlib.contextmanager
    def at(self, index: torch.Tensor) -> Iterator[None]:
        """Serve as the shard ``index`` (a 0-d tensor, e.g. a traced
        program's input) for the duration of the block."""
        saved, self.index = self.index, index
        try:
            yield
        finally:
            self.index = saved

    def _pick(self, table: torch.Tensor) -> torch.Tensor:
        return table.index_select(0, self.index.view(1))[0]

    def take(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's shard of the whole ``x`` along ``dim``."""
        dim %= x.dim()
        if x.shape[dim] % self.size:
            raise ValueError(f"{x.shape[dim]} rows do not divide over "
                             f"{self.size} shards")
        y = x.unflatten(dim, (self.size, x.shape[dim] // self.size))
        return y.index_select(dim, self.index.view(1)).flatten(dim, dim + 1)

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The whole tensor from every rank's shard along ``dim``."""
        return all_gather(x, dim, self.group, self.index)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum of ``x`` over the shards."""
        return all_sum(x, self.group)

    def halo(self, x: torch.Tensor, dim: int, lo: int, hi: int,
             replicate: bool = False) -> torch.Tensor:
        """``x`` with the ``lo`` rows above its shard and the ``hi`` rows
        below prepended and appended along ``dim``: rows of other ranks,
        zeros beyond the frame's edges (or, ``replicate``, the edge row)."""
        if lo == 0 and hi == 0:
            return x
        dim %= x.dim()
        rows = x.shape[dim]
        k = min(max(lo, hi), rows)
        edges = x if k == rows else torch.cat(
            [x.narrow(dim, 0, k), x.narrow(dim, rows - k, k)], dim)
        pos, keep = _on_device("halo", (self.size, rows, k, lo, hi,
                                        replicate), x.device)
        h = self.gather(edges, dim).index_select(dim, self._pick(pos))
        if not replicate:
            shape = [1] * x.dim()
            shape[dim] = lo + hi
            h = torch.where(self._pick(keep).view(shape), h,
                            torch.zeros((), dtype=h.dtype, device=h.device))
        return torch.cat([h.narrow(dim, 0, lo), x, h.narrow(dim, lo, hi)],
                         dim)

    def conv_rows(self, x: torch.Tensor, dim: int, k: int, stride: int,
                  dilation: int, top: int) -> torch.Tensor:
        """``x`` extended by the rows that a conv window (``k`` taps,
        ``stride``, ``dilation``, ``top`` rows of padding above the frame)
        reads across the shard's edges, so that the conv with no row
        padding gives exactly this shard's ``rows / stride`` output rows.
        A shard whose rows the stride does not divide is refused (GSPMD
        would pad it)."""
        rows = x.shape[dim]
        if rows % stride:
            raise ValueError(
                f"a shard of {rows} rows does not divide by a stride of "
                f"{stride}; pick a mesh the rows of every stage split "
                f"evenly over")
        return self.halo(x, dim, top,
                         max((k - 1) * dilation + 1 - stride - top, 0))

    def lerp_rows(self, x: torch.Tensor, dim: int, dst: int) -> torch.Tensor:
        """``ops/resize._lerp_axis`` of the rows: this shard's ``dst``
        output rows of the whole axis resized to ``size * dst``, in f32,
        value for value."""
        dim %= x.dim()
        i0, i1, frac = _on_device("lerp", (self.size, x.shape[dim], dst),
                                  x.device)
        ext = self.halo(x, dim, 1, 1, replicate=True)
        shape = [1] * x.dim()
        shape[dim] = dst
        frac = frac.view(shape)
        lo = ext.index_select(dim, i0).float()
        hi = ext.index_select(dim, i1).float()
        return lo * (1.0 - frac) + hi * frac


def install_rows(model: torch.nn.Module, rows) -> None:
    """Set ``rows`` (a :class:`RowShards`, or None to undo) on every
    submodule of ``model`` that has a ``rows`` attribute."""
    for mod in model.modules():
        if hasattr(type(mod), "rows"):
            mod.rows = rows


__all__ = ["RowShards", "install_rows", "all_gather", "all_sum", "wait"]
