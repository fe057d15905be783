"""Camera-frame preprocessing on the device.

Mirrors ``bugcar_image_segmentation_tpu/models/preprocess.py`` (reference
models.py:84-95): the raw uint8 BGR frame crosses to the device, then
bilinear resize → BGR→RGB → ``/256`` → ImageNet mean/std → the compute
dtype, NHWC.  Note the reference divides by 256, not 255; kept for parity.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..configs import ModelConfig
from ..ops import device_cache
from ..ops import resize as resize_ops

# ImageNet statistics (reference models.py:17-18).
IMAGE_MEAN = (0.485, 0.456, 0.406)
IMAGE_STD = (0.229, 0.224, 0.225)


@device_cache(maxsize=16)
def _const(values: Tuple[float, ...], device: torch.device) -> torch.Tensor:
    return torch.tensor(values, dtype=torch.float32, device=device)


def preprocess_frame(frame_bgr: torch.Tensor,
                     input_hw: Tuple[int, int],
                     mean: Tuple[float, float, float] = IMAGE_MEAN,
                     std: Tuple[float, float, float] = IMAGE_STD,
                     dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 BGR (..., H, W, 3) → normalized (..., h, w, 3) in ``dtype``."""
    x = frame_bgr.float()
    if tuple(frame_bgr.shape[-3:-1]) != tuple(input_hw):
        x = torch.movedim(x, -1, -3)                 # (..., 3, H, W)
        x = resize_ops.resize_bilinear(x, input_hw)  # (..., 3, h, w)
        x = torch.movedim(x, -3, -1)                 # (..., h, w, 3)
    x = x.flip(-1)                                   # BGR → RGB
    x = x * (1.0 / 256.0)
    x = (x - _const(tuple(mean), x.device)) / _const(tuple(std), x.device)
    return x.to(dtype)


def preprocess_for_config(frame_bgr: torch.Tensor,
                          cfg: ModelConfig) -> torch.Tensor:
    return preprocess_frame(
        frame_bgr,
        (cfg.input_height, cfg.input_width),
        mean=cfg.image_mean,
        std=cfg.image_std,
        dtype=getattr(torch, cfg.dtype),
    )


__all__ = ["preprocess_frame", "preprocess_for_config",
           "IMAGE_MEAN", "IMAGE_STD"]
