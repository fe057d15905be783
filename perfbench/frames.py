"""Camera frames from a seed: a copy of the program's procedural road
scenes (``synthetic.video``), rewritten to render on the device.

A pool entry is one frame of its own drive: a road wedge from a vanishing
point on the horizon, pavement shoulders, vegetation, sky, a dashed lane
line, up to three vehicles on the road, a colour tint, shading toward the
bottom corners and pixel noise (sd 6).  The geometry comes from numpy,
seeded by (seed, entry); the noise from a generator on the device.  Each
entry is a different scene, so a grid handed to the wrong frame shows.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from .weights import sub_seed

ROAD, LANE, PAVEMENT, VEGETATION, SKY, CAR = 0, 1, 2, 9, 10, 12
COLORS = {ROAD: (90, 90, 95), LANE: (200, 220, 230),
          PAVEMENT: (150, 150, 160), VEGETATION: (60, 130, 70),
          SKY: (230, 190, 150), CAR: (40, 40, 180)}
NOISE = 6.0


def scene(rng: np.random.Generator) -> dict:
    """One frame's geometry, a few frames into a drive (``synthetic.video``'s
    draws: horizon, steering, tint, obstacles approaching)."""
    i = int(rng.integers(0, 60))
    vp0 = rng.uniform(0.45, 0.55)
    amp, period = rng.uniform(0.02, 0.06), rng.uniform(40.0, 80.0)
    vp = vp0 + amp * np.sin(2 * np.pi * i / period)
    obstacles = [(rng.uniform(0.15, 1.0), rng.uniform(0.05, 0.09),
                  rng.uniform(0.6, 1.0), rng.uniform(-0.6, 0.6))
                 for _ in range(int(rng.integers(0, 4)))]
    return dict(horizon=rng.uniform(0.38, 0.46), vp=vp,
                center=vp0 + 0.5 * (vp - vp0),
                half=rng.uniform(0.30, 0.40),
                tint=rng.uniform(-15, 15, size=3), dash=i * 3,
                obstacles=obstacles)


def render(geo: dict, hw: Tuple[int, int], gen: torch.Generator,
           device) -> torch.Tensor:
    """(H, W, 3) uint8 BGR of one scene."""
    h, w = hw
    horizon = int(h * geo["horizon"])
    ys = torch.arange(h, device=device, dtype=torch.float32)[:, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, :]
    t = ((ys - horizon) / max(h - 1 - horizon, 1)).clamp(0.0, 1.0)
    center = w * geo["vp"] + (w * geo["center"] - w * geo["vp"]) * t
    half = w * geo["half"] * t
    label = torch.full((h, w), VEGETATION, dtype=torch.int64, device=device)
    label[:horizon] = SKY
    ground = ys >= horizon
    road = ground & ((xs - center).abs() <= half)
    pavement = ground & ~road & ((xs - center).abs()
                                 <= half + w * 0.06 * t + 2.0)
    label[pavement.expand(h, w)] = PAVEMENT
    label[road.expand(h, w)] = ROAD
    period = max(h // 16, 1)
    dash = ((ys.long() + geo["dash"]) // period) % 2 == 0
    lane = road & dash & ((xs - center).abs() <= (half * 0.04).clamp_min(1.0))
    label[lane.expand(h, w)] = LANE
    for u, width, aspect, off in geo["obstacles"]:
        oy = int(np.clip(horizon + u * (h - 1 - horizon), horizon + 1, h - 4))
        t_o = (oy - horizon) / max(h - 1 - horizon, 1)
        ow = max(4, int(w * width * t_o * 2))
        oh = max(4, int(ow * aspect))
        c_o = float(center[oy, 0]) + off * float(half[oy, 0])
        ox = int(np.clip(c_o, ow, w - ow))
        label[max(0, oy - oh):oy, max(0, ox - ow // 2):ox + ow // 2] = CAR
    palette = torch.zeros((13, 3), device=device)
    for cls, color in COLORS.items():
        palette[cls] = torch.tensor(color, dtype=torch.float32,
                                    device=device)
    frame = palette[label] + torch.as_tensor(geo["tint"], dtype=torch.float32,
                                             device=device)
    frame = frame + NOISE * torch.randn(frame.shape, generator=gen,
                                        device=device)
    shade = 1.0 - 0.15 * t * (xs - w / 2).abs() / (w / 2)
    return (frame * shade[..., None]).clamp(0, 255).to(torch.uint8)


def pool(seed: int, count: int, hw: Tuple[int, int], device,
         stream: int = 2) -> np.ndarray:
    """(count, H, W, 3) uint8 BGR frames in host memory: the camera
    frames the program takes, as a camera driver hands them over."""
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, stream))
    frames = torch.stack([
        render(scene(np.random.default_rng([seed, stream, j])), hw, gen,
               device) for j in range(count)])
    return frames.cpu().numpy()
