"""Batched data augmentation for segmentation training.

Port of ``bugcar_image_segmentation_tpu/training/augment.py``: a
horizontal flip, a zoom about a random centre (bilinear for the image,
nearest for the label, out-of-view labels become ``ignore_label``), then
brightness, contrast, saturation and gaussian noise on the image, in that
order, on (N, H, W, 3) float images in [0, 1].  Shapes and dtypes are
kept.

The work is split in two: :func:`draw_params` draws the per-sample
parameters from a ``torch.Generator`` (flip, scale, cx, cy, brightness,
contrast factor, saturation factor and a standard-normal noise field), and
:func:`apply_params` applies them deterministically; :func:`augment_batch`
is both.  Given the parameters that the JAX function draws from its key,
:func:`apply_params` gives its labels exactly and its images to float32
rounding: a bilinear weight is ``sx - floor(sx)``, so the one ulp of the
source coordinate by which XLA's fused multiply-adds round it otherwise
moves a pixel by up to that ulp (3.8e-6 below x = 64).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
    """The knobs of :func:`augment_batch`; ranges are per-sample uniform.
    Defaults are the JAX package's."""

    flip: bool = True                           # horizontal mirror, p=0.5
    scale: Tuple[float, float] = (0.75, 1.25)   # random zoom (area crop)
    brightness: float = 0.2                     # +/- additive, [0,1] space
    contrast: float = 0.2                       # +/- multiplicative
    saturation: float = 0.2                     # +/- around the gray axis
    noise_std: float = 0.01                     # gaussian, [0,1] space
    ignore_label: int = 255                     # fill for out-of-view labels


def _uniform(g: torch.Generator, n: int, lo: float, hi: float
             ) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(n, generator=g)


def draw_params(generator: torch.Generator, shape: Tuple[int, ...],
                cfg: AugmentConfig = AugmentConfig()
                ) -> Dict[str, Optional[torch.Tensor]]:
    """Per-sample parameters for a batch of ``shape`` (N, H, W, C), drawn
    on the CPU; a switched-off augmentation draws nothing (None)."""
    n, h, w = shape[:3]
    g = generator
    out: Dict[str, Optional[torch.Tensor]] = dict.fromkeys(
        ("flip", "scale", "cx", "cy", "brightness", "contrast",
         "saturation", "noise"))
    if cfg.flip:
        out["flip"] = torch.rand(n, generator=g) < 0.5
    lo, hi = cfg.scale
    if (lo, hi) != (1.0, 1.0):
        s = _uniform(g, n, lo, hi)
        # centre jitter keeps a zoomed-in window inside the frame;
        # zoomed out, it stays centred
        slack_y = ((h - 1) * (1 - s) / 2.0).clamp_min(0.0)
        slack_x = ((w - 1) * (1 - s) / 2.0).clamp_min(0.0)
        out["scale"] = s
        out["cy"] = (h - 1) / 2.0 + _uniform(g, n, -1.0, 1.0) * slack_y
        out["cx"] = (w - 1) / 2.0 + _uniform(g, n, -1.0, 1.0) * slack_x
    if cfg.brightness > 0:
        out["brightness"] = _uniform(g, n, -cfg.brightness, cfg.brightness)
    if cfg.contrast > 0:
        out["contrast"] = 1.0 + _uniform(g, n, -cfg.contrast, cfg.contrast)
    if cfg.saturation > 0:
        out["saturation"] = 1.0 + _uniform(g, n, -cfg.saturation,
                                           cfg.saturation)
    if cfg.noise_std > 0:
        out["noise"] = torch.randn(tuple(shape), generator=g)
    return out


def _affine_resample(images: torch.Tensor, labels: torch.Tensor,
                     scale: torch.Tensor, cx: torch.Tensor, cy: torch.Tensor,
                     ignore_label: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Resample (N, H, W, C) images and (N, H, W) labels through a zoom:
    output pixel (i, j) of sample b reads source (cy + (i - (H-1)/2) *
    scale, cx + (j - (W-1)/2) * scale); bilinear image taps, the nearest
    label (round half to even), 0 / ``ignore_label`` out of the frame."""
    n, h, w, c = images.shape
    dev = images.device
    ys = cy[:, None] + (torch.arange(h, dtype=torch.float32, device=dev)
                        - (h - 1) / 2.0) * scale[:, None]
    xs = cx[:, None] + (torch.arange(w, dtype=torch.float32, device=dev)
                        - (w - 1) / 2.0) * scale[:, None]
    sy = ys[:, :, None].expand(n, h, w)
    sx = xs[:, None, :].expand(n, h, w)
    inb = (sy >= 0) & (sy <= h - 1) & (sx >= 0) & (sx <= w - 1)
    y0 = torch.floor(sy).clamp(0, h - 1)
    x0 = torch.floor(sx).clamp(0, w - 1)
    fy = (sy - y0).clamp(0.0, 1.0)[..., None]
    fx = (sx - x0).clamp(0.0, 1.0)[..., None]
    y0i, x0i = y0.long(), x0.long()
    y1i = (y0i + 1).clamp_max(h - 1)
    x1i = (x0i + 1).clamp_max(w - 1)
    flat = images.reshape(n, h * w, c)

    def tap(yi, xi):
        idx = (yi * w + xi).reshape(n, h * w, 1).expand(n, h * w, c)
        return flat.gather(1, idx).reshape(n, h, w, c)

    top = tap(y0i, x0i) * (1 - fx) + tap(y0i, x1i) * fx
    bot = tap(y1i, x0i) * (1 - fx) + tap(y1i, x1i) * fx
    img = top * (1 - fy) + bot * fy
    img = torch.where(inb[..., None], img, 0.0).to(images.dtype)
    yn = torch.round(sy).clamp(0, h - 1).long()
    xn = torch.round(sx).clamp(0, w - 1).long()
    lbl = labels.reshape(n, h * w).gather(
        1, (yn * w + xn).reshape(n, h * w)).reshape(n, h, w)
    lbl = torch.where(inb, lbl, torch.full_like(lbl, ignore_label))
    return img, lbl


def apply_params(images: torch.Tensor, labels: torch.Tensor,
                 params: Dict[str, Optional[torch.Tensor]],
                 cfg: AugmentConfig = AugmentConfig()
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply :func:`draw_params`' parameters to (N, H, W, 3) float images
    in [0, 1] and their (N, H, W) integer labels, on their device."""
    if images.dim() != 4 or labels.dim() != 3:
        raise ValueError(f"expected (N,H,W,C) images + (N,H,W) labels, got "
                         f"{tuple(images.shape)} / {tuple(labels.shape)}")
    dev = images.device
    p = {k: None if v is None else v.to(dev) for k, v in params.items()}
    if p["flip"] is not None:
        images = torch.where(p["flip"][:, None, None, None],
                             images.flip(2), images)
        labels = torch.where(p["flip"][:, None, None], labels.flip(2),
                             labels)
    if p["scale"] is not None:
        images, labels = _affine_resample(images, labels, p["scale"],
                                          p["cx"], p["cy"], cfg.ignore_label)
    f32 = images.float()
    if p["brightness"] is not None:
        f32 = f32 + p["brightness"][:, None, None, None]
    if p["contrast"] is not None:
        mean = f32.mean(dim=(1, 2, 3), keepdim=True)
        f32 = (f32 - mean) * p["contrast"][:, None, None, None] + mean
    if p["saturation"] is not None:
        gray = f32.mean(dim=-1, keepdim=True)
        f32 = gray + (f32 - gray) * p["saturation"][:, None, None, None]
    if p["noise"] is not None:
        f32 = f32 + cfg.noise_std * p["noise"]
    return f32.clamp(0.0, 1.0).to(images.dtype), labels


def augment_batch(generator: torch.Generator, images: torch.Tensor,
                  labels: torch.Tensor, cfg: AugmentConfig = AugmentConfig()
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Draw per-sample parameters from ``generator`` and apply them."""
    return apply_params(images, labels,
                        draw_params(generator, tuple(images.shape), cfg),
                        cfg)


__all__ = ["AugmentConfig", "augment_batch", "draw_params", "apply_params"]
