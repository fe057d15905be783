"""Calibration-time geometry: homography solve, corner ordering, lines.

A copy of ``bugcar_image_segmentation_tpu/geometry.py`` (pure NumPy), kept
in the port so that it never imports the JAX package.

This is the cold path (runs once per calibration), so it is plain
NumPy — no reason to trace it.  It replaces the reference's dependence on
``cv2.getPerspectiveTransform`` (reference bev.py:88) with an explicit
8x8 linear solve, and reimplements the corner-ordering and line-intersection
helpers (reference utils.py:10-44, image_processing_utils.py:63-91) from
their mathematical definitions.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Homography
# ---------------------------------------------------------------------------


def get_perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography H mapping 4 ``src`` points onto 4 ``dst`` points.

    Equivalent to ``cv2.getPerspectiveTransform`` (used at reference
    bev.py:88): solves the 8-unknown linear system

        [x' y' 1]^T ~ H [x y 1]^T   with  H[2,2] = 1.

    Args:
      src: (4, 2) source points.
      dst: (4, 2) destination points.

    Returns:
      (3, 3) float64 homography with H[2,2] == 1.
    """
    src = np.asarray(src, dtype=np.float64)
    dst = np.asarray(dst, dtype=np.float64)
    if src.shape != (4, 2) or dst.shape != (4, 2):
        raise ValueError(f"need 4 source and 4 destination points, got "
                         f"{src.shape} and {dst.shape}")

    a = np.zeros((8, 8), dtype=np.float64)
    b = np.zeros((8,), dtype=np.float64)
    for i in range(4):
        x, y = src[i]
        u, v = dst[i]
        a[2 * i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[2 * i + 1] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[2 * i] = u
        b[2 * i + 1] = v

    h = np.linalg.solve(a, b)
    return np.concatenate([h, [1.0]]).reshape(3, 3)


def invert_homography(m: np.ndarray) -> np.ndarray:
    """Inverse homography, normalised so the [2,2] element is 1."""
    inv = np.linalg.inv(np.asarray(m, dtype=np.float64))
    return inv / inv[2, 2]


def apply_homography(m: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply a 3x3 homography to (..., 2) points."""
    pts = np.asarray(pts, dtype=np.float64)
    ones = np.ones(pts.shape[:-1] + (1,), dtype=np.float64)
    homo = np.concatenate([pts, ones], axis=-1)
    out = homo @ np.asarray(m, dtype=np.float64).T
    return out[..., :2] / out[..., 2:3]


# ---------------------------------------------------------------------------
# Fiducial corner ordering
# ---------------------------------------------------------------------------


def order_points_counter_clockwise(points: np.ndarray,
                                   x_axis: np.ndarray) -> np.ndarray:
    """Order 4 fiducial corners stably relative to an oriented axis.

    Reimplements the ordering convention of reference utils.py:10-44 so
    calibration matrices are interchangeable: rotate all points so the
    fiducial x-axis (given as ``[center, point_on_axis]``) aligns with the
    image x-axis, split the points by the sign of their rotated
    y-coordinate (y >= 0 → "left" side, y < 0 → "right" side), sort each
    side by rotated x, and return left-side points followed by right-side
    points, in the *original* coordinates.

    Args:
      points: (4, 2) corner points.
      x_axis: (2, 2): row 0 = axis origin, row 1 = a point on the +x axis.
        NOTE: the reference mutated this argument in place
        (utils.py:15); we do not.

    Returns:
      (4, 2) reordered copy of ``points``.
    """
    points = np.asarray(points, dtype=np.float64)
    axis = np.asarray(x_axis, dtype=np.float64).copy()
    center = axis[0].copy()
    translated = points - center
    axis = axis - center
    # Rotation that maps the fiducial axis onto the image x-axis.
    rotation = -np.arctan2(axis[1, 1], axis[1, 0])
    c, s = np.cos(rotation), np.sin(rotation)
    rot = np.array([[c, -s], [s, c]])
    rotated = translated @ rot.T

    order = np.arange(4)
    left = [i for i in order if rotated[i, 1] >= 0]
    right = [i for i in order if rotated[i, 1] < 0]
    left.sort(key=lambda i: rotated[i, 0])
    right.sort(key=lambda i: rotated[i, 0])
    return points[left + right]


# ---------------------------------------------------------------------------
# Line intersection (calibration helper)
# ---------------------------------------------------------------------------


def find_intersection_line(line1: Sequence[Sequence[float]],
                           line2: Sequence[Sequence[float]],
                           ) -> Optional[np.ndarray]:
    """Intersection of two lines, each given by two points.

    Same contract as reference image_processing_utils.py:63-91: each line is
    ((x1, y1), (x2, y2)); returns ``None`` for parallel lines (including two
    vertical lines), else the (x, y) intersection.
    """
    (x1, y1), (x2, y2) = np.asarray(line1, dtype=np.float64)
    (x3, y3), (x4, y4) = np.asarray(line2, dtype=np.float64)

    # Represent each line as a*x + b*y = c.
    if x2 == x1:
        a1, b1, c1 = 1.0, 0.0, x1
    else:
        a1, b1 = (y2 - y1) / (x2 - x1), -1.0
        c1 = (x1 * y2 - x2 * y1) / (x2 - x1)
    if x4 == x3:
        a2, b2, c2 = 1.0, 0.0, x3
    else:
        a2, b2 = (y4 - y3) / (x4 - x3), -1.0
        c2 = (x3 * y4 - x4 * y3) / (x4 - x3)

    if a1 == a2 and b1 == b2:
        return None
    coeff = np.array([[a1, b1], [a2, b2]])
    if abs(np.linalg.det(coeff)) < 1e-12:
        return None
    return np.linalg.solve(coeff, np.array([c1, c2]))


def corners_from_edge_lines(lines: Sequence[Sequence[Sequence[float]]]
                            ) -> np.ndarray:
    """Locate the 4 fiducial-tile corners from its 4 edge lines.

    The reference's calibration flow found tile corners by intersecting
    detected edge lines (image_processing_utils.py:63-91 feeding the
    missing calibration script; SURVEY.md §3.2) — this is the execution
    path for that capability.  ``lines``: 4 lines in order around the
    tile (e.g. top, right, bottom, left), each given by two points
    ((x1, y1), (x2, y2)).  Corner ``i`` is the intersection of line
    ``i`` and line ``(i+1) % 4``.

    Returns a (4, 2) float array in CYCLIC (traversal) order — NOT the
    solver's convention; pass the result through
    :func:`order_corners_for_calibration` before
    :func:`calculate_transform_matrix` or the homography pairs corners
    diagonally.  Raises ValueError if any consecutive pair is parallel
    (no corner).
    """
    lines = [np.asarray(l, dtype=np.float64) for l in lines]
    if len(lines) != 4:
        raise ValueError(f"need exactly 4 edge lines, got {len(lines)}")
    corners = []
    for i in range(4):
        pt = find_intersection_line(lines[i], lines[(i + 1) % 4])
        if pt is None:
            raise ValueError(
                f"edge lines {i} and {(i + 1) % 4} are parallel — "
                f"no corner")
        corners.append(pt)
    return np.stack(corners)


def order_corners_for_calibration(corners: np.ndarray,
                                  yaw: float = 0.0) -> np.ndarray:
    """Reorder camera-image tile corners into the solver's convention.

    ``calculate_transform_matrix`` pairs ``tile_coords`` positionally
    with :func:`bev_tile_corners`, whose order is
    ``order_points_counter_clockwise`` relative to the yaw-rotated
    fiducial x-axis (reference bev.py:85 orders only the BEV side; the
    camera side was the job of the missing calibration script, which is
    what reference utils.py:10-44 exists for).  This applies the same
    labeling on the camera side: axis = the corners' centroid toward
    image direction ``(cos yaw, sin yaw)`` — for a forward camera the
    fiducial x-axis appears image-right rotated by roughly the same
    yaw, and the split-by-axis labeling is stable under ground-plane
    perspective (property-tested over all 4! input orders,
    tests/test_geometry.py).

    Accepts corners in ANY order (cyclic from
    :func:`corners_from_edge_lines`, arbitrary clicks) and returns the
    (4, 2) convention-ordered copy to hand to the solver.
    """
    corners = np.asarray(corners, dtype=np.float64)
    if corners.shape != (4, 2):
        raise ValueError(f"need (4, 2) corners, got {corners.shape}")
    center = corners.mean(axis=0)
    axis = np.stack([center,
                     center + np.array([np.cos(yaw), np.sin(yaw)])])
    return order_points_counter_clockwise(corners, axis)


# ---------------------------------------------------------------------------
# BEV corner construction (calibration core)
# ---------------------------------------------------------------------------


def bev_tile_corners(output_shape: Tuple[int, int],
                     dist2target: Tuple[float, float],
                     tile_length: float,
                     cm_per_px: float,
                     yaw: float) -> np.ndarray:
    """Ideal BEV-pixel positions of the 4 fiducial-tile corners.

    Reimplements reference bev.py:58-86: place a square of edge
    ``tile_length`` (cm) centred at the target location, rotate it by
    ``yaw`` about the target, translate so the target sits at
    (W/2 + dx, H - dy) in BEV pixels, and order the corners
    counter-clockwise relative to the rotated fiducial x-axis.

    Args:
      output_shape: (width, height) of the BEV image in pixels.
      dist2target: (x, y) camera→target distance in cm.
      tile_length: fiducial edge in cm.
      cm_per_px: BEV scale.
      yaw: fiducial yaw, radians.

    Returns:
      (4, 2) float64 BEV pixel coordinates, ordered for
      ``get_perspective_transform``.
    """
    width, height = output_shape
    dist2target_px = (dist2target[0] / cm_per_px, dist2target[1] / cm_per_px)
    half = (tile_length / cm_per_px) / 2.0
    corners = np.array([[half, half],
                        [half, -half],
                        [-half, -half],
                        [-half, half]], dtype=np.float64)

    c, s = np.cos(yaw), np.sin(yaw)
    rot = np.array([[c, -s], [s, c]])
    target_in_img = np.array([width / 2.0 + dist2target_px[0],
                              height - dist2target_px[1]])

    rotated = corners @ rot.T + target_in_img
    axis_tip = rot @ np.array([100.0, 0.0]) + target_in_img
    axis = np.stack([target_in_img, axis_tip], axis=0)
    return order_points_counter_clockwise(rotated, axis)


def calculate_transform_matrix(tile_coords: np.ndarray,
                               output_shape: Tuple[int, int],
                               dist2target: Tuple[float, float],
                               tile_length: float,
                               cm_per_px: float,
                               yaw: float) -> np.ndarray:
    """Homography mapping camera-image tile corners to their ideal BEV spots.

    Functional equivalent of reference bev.py:58-92.  ``tile_coords`` are
    the 4 fiducial corners located in the *camera* image (same ordering
    convention as ``order_points_counter_clockwise``).
    """
    tile_coords = np.asarray(tile_coords, dtype=np.float64)
    bev_pts = bev_tile_corners(output_shape, dist2target, tile_length,
                               cm_per_px, yaw)
    # cv2.getPerspectiveTransform operates in float32; match its input
    # precision so matrices are interchangeable with reference-produced ones.
    return get_perspective_transform(
        tile_coords.astype(np.float32).astype(np.float64),
        bev_pts.astype(np.float32).astype(np.float64))


__all__ = [
    "get_perspective_transform",
    "invert_homography",
    "apply_homography",
    "order_points_counter_clockwise",
    "find_intersection_line",
    "corners_from_edge_lines",
    "order_corners_for_calibration",
    "bev_tile_corners",
    "calculate_transform_matrix",
]
