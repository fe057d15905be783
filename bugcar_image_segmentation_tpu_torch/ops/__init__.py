"""Device ops of the PyTorch port: resamplers, pooling, morphology, the
homography warp, and the hand-written CUDA kernels (``ops.cuda``)."""

from __future__ import annotations

import functools

import torch


def device_cache(maxsize: int):
    """``functools.lru_cache`` for a function that makes device tensors
    from hashable arguments, bypassed while ``torch.export`` traces: the
    tensors made then are the trace's fake tensors, which must not outlive
    it (``deploy.py``)."""
    def wrap(fn):
        cached = functools.lru_cache(maxsize=maxsize)(fn)

        @functools.wraps(fn)
        def call(*args, **kwargs):
            if torch.compiler.is_exporting():
                return fn(*args, **kwargs)
            return cached(*args, **kwargs)

        call.cache_clear = cached.cache_clear
        call.cache_info = cached.cache_info
        return call
    return wrap
