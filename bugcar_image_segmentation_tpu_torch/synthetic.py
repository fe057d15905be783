"""Procedural road scenes with ground-truth labels.

The reference's training data and test set never shipped ("test set not
included", reference README.md:14), so nothing in this repo could
demonstrate *learned* behaviour end to end.  This generator renders
simple but perspective-consistent driving scenes — a road wedge toward a
vanishing point, dashed lane markings, pavement shoulders, vegetation,
sky, box obstacles — with pixel-perfect labels in the ENet class
vocabulary (reference note_label:1-15: 0 road, 1 lane marking,
2 pavement, 9 vegetation, 10 sky, 12 vehicle), enabling:

- training/fine-tuning runs that actually converge to meaningful masks
  (scripts/make_demo_checkpoint.py);
- accuracy/IoU evaluation with real ground truth (evaluation.py);
- demos whose occupancy grids show a drivable corridor, not noise.

Pure numpy, deterministic per seed.  A copy of
``bugcar_image_segmentation_tpu/synthetic.py``: the same seed gives the
same frames in both packages.
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np

# Class ids (reference note_label order).
ROAD, LANE, PAVEMENT, VEGETATION, SKY, CAR = 0, 1, 2, 9, 10, 12

_COLORS = {  # BGR base colors per class, jittered per scene
    ROAD: (90, 90, 95),
    LANE: (200, 220, 230),
    PAVEMENT: (150, 150, 160),
    VEGETATION: (60, 130, 70),
    SKY: (230, 190, 150),
    CAR: (40, 40, 180),
}


def _render_scene(shape: Tuple[int, int],
                  horizon_f: float,
                  vp_x_f: float,
                  half_base_f: float,
                  center_base_f: float,
                  obstacles,
                  tint: np.ndarray,
                  rng_noise: np.random.Generator,
                  noise: float,
                  dash_phase: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """Rasterize one scene from explicit geometry parameters.

    ``obstacles`` is a list of ``(oy, width_frac, aspect, center_off)``
    with ``oy`` in pixels, width as a fraction of ``w`` (pre-perspective),
    aspect = height/width, ``center_off`` in [-1, 1] of the road half
    width.  ``dash_phase`` scrolls the lane dashes (forward ego motion).
    """
    h, w = shape
    label = np.full((h, w), VEGETATION, np.int32)

    horizon = int(h * horizon_f)
    label[:horizon] = SKY

    vp_x = w * vp_x_f
    half_base = w * half_base_f
    center_base = w * center_base_f

    ys = np.arange(h)[:, None].astype(np.float32)
    xs = np.arange(w)[None, :].astype(np.float32)
    t = np.clip((ys - horizon) / max(h - 1 - horizon, 1), 0.0, 1.0)
    center = vp_x + (center_base - vp_x) * t     # road centerline per row
    half = half_base * t                          # widens toward the camera

    ground = ys >= horizon
    road = ground & (np.abs(xs - center) <= half)
    pavement = ground & ~road & (np.abs(xs - center) <= half
                                 + w * 0.06 * t + 2.0)
    label[pavement] = PAVEMENT
    label[road] = ROAD

    # dashed center lane marking
    lane_half = np.maximum(1.0, half * 0.04)
    dash_period = max(h // 16, 1)
    dash = (((ys.astype(int) + dash_phase) // dash_period) % 2 == 0)
    lane = road & dash & (np.abs(xs - center) <= lane_half)
    label[lane] = LANE

    # obstacles on the road
    for oy, width_frac, aspect, center_off in obstacles:
        oy = int(np.clip(oy, horizon + 1, h - 4))
        t_o = (oy - horizon) / max(h - 1 - horizon, 1)
        ow = max(4, int(w * width_frac * t_o * 2))
        oh = max(4, int(ow * aspect))
        ox = int(np.clip(center[oy, 0] + center_off * half[oy, 0],
                         ow, w - ow))
        label[max(0, oy - oh):oy, max(0, ox - ow // 2):ox + ow // 2] = CAR

    # render: per-class base color + per-scene tint + pixel noise
    frame = np.empty((h, w, 3), np.float32)
    for cls, color in _COLORS.items():
        mask = label == cls
        frame[mask] = np.asarray(color, np.float32) + tint
    frame += rng_noise.normal(0.0, noise, size=frame.shape)
    # simple shading: darker toward the bottom corners
    shade = 1.0 - 0.15 * t * np.abs(xs - w / 2) / (w / 2)
    frame *= shade[..., None]
    return (np.clip(frame, 0, 255).astype(np.uint8), label)


def road_scene(rng: np.random.Generator,
               shape: Tuple[int, int] = (256, 512),
               noise: float = 12.0) -> Tuple[np.ndarray, np.ndarray]:
    """One (bgr uint8 frame, int32 label map) pair.

    Geometry: horizon at 35-50% height; road is a wedge from a vanishing
    point on the horizon to a random base span; pavement borders it;
    vegetation fills the rest of the ground; 0-3 box obstacles sit on the
    road; a dashed center lane line runs toward the vanishing point.

    (Parameter sampling below preserves the historical rng draw order so
    seeded datasets — and the demo checkpoint trained on them — are
    unchanged by the video refactor.)
    """
    h, w = shape
    horizon_f = int(h * rng.uniform(0.35, 0.5)) / h
    vp_x_f = rng.uniform(0.35, 0.65)
    half_base_f = rng.uniform(0.25, 0.45)
    center_base_f = rng.uniform(0.35, 0.65)

    horizon = int(h * horizon_f)
    obstacles = []
    for _ in range(rng.integers(0, 4)):
        oy = rng.integers(horizon + (h - horizon) // 4, h - 4)
        width_frac = rng.uniform(0.04, 0.10)
        aspect = rng.uniform(0.6, 1.0)
        center_off = rng.uniform(-0.8, 0.8)
        obstacles.append((int(oy), float(width_frac), float(aspect),
                          float(center_off)))
    tint = rng.uniform(-20, 20, size=3)
    return _render_scene(shape, horizon_f, vp_x_f, half_base_f,
                         center_base_f, obstacles, tint, rng, noise)


def video(seed: int = 0,
          num_frames: int = 30,
          shape: Tuple[int, int] = (256, 512),
          noise: float = 6.0,
          speed_mps: float = 4.0,
          fps: float = 30.0,
          grid_depth_m: float = 8.0,
          ) -> Iterator[Tuple[np.ndarray, np.ndarray, Tuple[float, float,
                                                            float]]]:
    """A temporally coherent driving sequence with per-frame odometry.

    Unlike :func:`road_scene` (i.i.d. stills), consecutive frames share
    smoothly varying geometry: the vanishing point drifts with a gentle
    steering oscillation, lane dashes scroll toward the camera, and
    obstacles grow/approach with forward motion — the synthetic stand-in
    for the RealSense recordings the reference pipeline consumed
    (reference README.md:16-23; no recordings survive in the snapshot).

    Yields ``(bgr uint8 frame, int32 label map, odometry)`` where
    odometry is ``(dx_m, dy_m, dyaw_rad)`` — the ego displacement since
    the previous frame in the vehicle frame (x forward, y left), sized
    for the JAX package's ``fusion.TemporalGridFusion``.
    """
    h, w = shape
    rng = np.random.default_rng(seed)
    horizon_f = rng.uniform(0.38, 0.46)
    vp0 = rng.uniform(0.45, 0.55)
    half_base_f = rng.uniform(0.30, 0.40)
    steer_amp = rng.uniform(0.02, 0.06)          # vp oscillation amplitude
    steer_period = rng.uniform(40.0, 80.0)       # frames per oscillation
    tint = rng.uniform(-15, 15, size=3)
    horizon = int(h * horizon_f)

    # Obstacles spawn ahead (near the horizon) and approach with speed.
    # Position tracked in "ground distance" u in (0, 1]: u=0 at horizon,
    # u=1 at the bumper; perspective row oy = horizon + u*(h-1-horizon).
    dist_px = max(h - 1 - horizon, 1)
    obstacles = []                                # [u, width, aspect, off]
    next_spawn = 0
    du = speed_mps / fps / grid_depth_m * 0.6     # ground-rate per frame

    dx_per_frame = speed_mps / fps
    dash_px_rate = du * dist_px                   # dash scroll ≈ ground rate

    for i in range(num_frames):
        phase = 2 * np.pi * i / steer_period
        vp_x_f = vp0 + steer_amp * np.sin(phase)
        dyaw = float(-steer_amp * (2 * np.pi / steer_period)
                     * np.cos(phase) * 1.2)       # d(vp)/dt → yaw rate
        center_base_f = vp0 + 0.5 * (vp_x_f - vp0)

        if i >= next_spawn and len(obstacles) < 3:
            obstacles.append([rng.uniform(0.15, 0.3),
                              float(rng.uniform(0.05, 0.09)),
                              float(rng.uniform(0.6, 1.0)),
                              float(rng.uniform(-0.6, 0.6))])
            next_spawn = i + int(rng.integers(8, 20))
        for ob in obstacles:
            ob[0] += du
        obstacles = [ob for ob in obstacles if ob[0] <= 1.0]

        rendered = [(int(horizon + ob[0] * dist_px), ob[1], ob[2], ob[3])
                    for ob in obstacles]
        frame, label = _render_scene(
            shape, horizon_f, vp_x_f, half_base_f, center_base_f,
            rendered, tint, np.random.default_rng(seed * 7919 + i),
            noise, dash_phase=int(round(i * dash_px_rate)))
        yield frame, label, (dx_per_frame, 0.0, dyaw)


def dataset(seed: int = 0,
            num: int = 100,
            shape: Tuple[int, int] = (256, 512),
            ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
    """Deterministic stream of (frame, label) pairs."""
    for i in range(num):
        yield road_scene(np.random.default_rng(seed * 100003 + i), shape)


__all__ = ["road_scene", "dataset", "video", "ROAD", "LANE", "PAVEMENT",
           "VEGETATION", "SKY", "CAR"]
