"""Device ops of the PyTorch port: resamplers, pooling, morphology, the
homography warp, and the hand-written CUDA kernels (``ops.cuda``)."""

from __future__ import annotations

import contextlib
import functools
from typing import Iterator, List, Optional

import torch

_held: Optional[List] = None     # open held_cache() block's list, or None


def device_cache(maxsize: int):
    """``functools.lru_cache`` for a function that makes device tensors
    from hashable arguments, bypassed while ``torch.export`` traces: the
    tensors made then are the trace's fake tensors, which must not outlive
    it (``deploy.py``).  Inside :func:`held_cache` each value returned is
    also kept in that block's list."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if torch.compiler.is_exporting():
                return fn(*args, **kwargs)
            out = cached(*args, **kwargs)
            if _held is not None:
                _held.append(out)
            return out

        call.cache_clear = cached.cache_clear
        call.cache_info = cached.cache_info
        return call
    return wrap


@contextlib.contextmanager
def held_cache() -> Iterator[List]:
    """A list of every value a :func:`device_cache` function returns in
    the block.  A CUDA graph captured in the block reads those tensors at
    each replay; holding the list keeps their memory from being freed when
    the cache evicts them (``models/api.py``)."""
    global _held
    outer, _held = _held, []
    try:
        yield _held
    finally:
        _held = outer
