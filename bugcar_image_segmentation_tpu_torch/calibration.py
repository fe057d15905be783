"""Camera→BEV calibration object, API-compatible with the reference.

``BEVTransform`` plays the role of the reference's ``bev_transform_tools``
(reference bev.py:8-92): it owns the calibration state, computes the
homography from located fiducial corners, and round-trips the calibration
JSON with the reference's exact schema (reference bev.py:47-55, with the
``is_laserscan`` asymmetry at bev.py:37 fixed — see configs.py).

The *grid building* that the reference also hung off this class
(bev.py:97-246) lives in :mod:`grid` here, as torch ops on the device;
this module is pure host-side geometry.

Mirrors ``bugcar_image_segmentation_tpu/calibration.py``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from . import geometry
from .configs import CalibrationConfig


class BEVTransform:
    """Calibrated homography from camera image to bird's-eye view."""

    def __init__(self,
                 input_shape: Tuple[int, int],
                 output_shape: Tuple[int, int],
                 dist2target: Tuple[float, float],
                 tile_length: float,
                 cm_per_px: float,
                 yaw: float,
                 laserscan: bool = False,
                 matrix: Optional[np.ndarray] = None):
        self.config = CalibrationConfig(
            input_shape=tuple(int(v) for v in input_shape),
            output_shape=tuple(int(v) for v in output_shape),
            dist2target=tuple(float(v) for v in dist2target),
            tile_length=float(tile_length),
            cm_per_px=float(cm_per_px),
            yaw=float(yaw),
            laserscan=bool(laserscan),
        )
        if matrix is not None:
            self.config = self.config.with_matrix(np.asarray(matrix))

    # -- accessors -----------------------------------------------------------

    @property
    def matrix(self) -> np.ndarray:
        """The 3x3 camera→BEV homography."""
        return self.config.matrix_np()

    @property
    def input_shape(self) -> Tuple[int, int]:
        return self.config.input_shape

    @property
    def output_shape(self) -> Tuple[int, int]:
        return self.config.output_shape

    @property
    def laserscan(self) -> bool:
        return self.config.laserscan

    # -- calibration ---------------------------------------------------------

    def calculate_transform_matrix(self, tile_coords: np.ndarray) -> np.ndarray:
        """Solve the homography from 4 located fiducial corners.

        Equivalent to reference bev.py:58-92.  ``tile_coords``: (4, 2)
        corners of the physical tile as seen in the camera image.
        """
        m = geometry.calculate_transform_matrix(
            tile_coords,
            output_shape=self.config.output_shape,
            dist2target=self.config.dist2target,
            tile_length=self.config.tile_length,
            cm_per_px=self.config.cm_per_px,
            yaw=self.config.yaw,
        )
        self.config = self.config.with_matrix(m)
        return m

    # -- persistence (reference-schema JSON) ----------------------------------

    def save_to_json(self, path: str) -> None:
        """Write the calibration with the reference's key schema."""
        self.config.save_json(path)

    # Alias matching the reference method name (bev.py:44).
    save_to_JSON = save_to_json

    @classmethod
    def from_json(cls, path: str) -> "BEVTransform":
        """Load a calibration file written by us *or* by the reference."""
        cfg = CalibrationConfig.load_json(path)
        return cls(
            input_shape=cfg.input_shape,
            output_shape=cfg.output_shape,
            dist2target=cfg.dist2target,
            tile_length=cfg.tile_length,
            cm_per_px=cfg.cm_per_px,
            yaw=cfg.yaw,
            laserscan=cfg.laserscan,
            matrix=cfg.matrix_np(),
        )

    # Alias matching the reference classmethod name (bev.py:24).
    fromJSON = from_json



def toy_calibration(input_hw: Tuple[int, int],
                    yaw: float = 0.05) -> CalibrationConfig:
    """A plausible synthetic camera→BEV calibration (256x256 BEV image)
    for an input of ``input_hw`` (the numbers of the JAX repo's
    ``__graft_entry__._toy_calibration``): a fiducial tile seen ahead of
    the camera, solved with this package's geometry; ``yaw`` (radians)
    turns the camera, as the cameras of a rig are turned."""
    h, w = input_hw
    cal = CalibrationConfig(
        input_shape=(w, h), output_shape=(256, 256),
        dist2target=(2.0, 60.0), tile_length=60.0, cm_per_px=2.0, yaw=yaw)
    tile = np.array([[0.41 * w, 0.55 * h], [0.59 * w, 0.55 * h],
                     [0.64 * w, 0.72 * h], [0.36 * w, 0.73 * h]])
    m = geometry.calculate_transform_matrix(
        tile, output_shape=cal.output_shape, dist2target=cal.dist2target,
        tile_length=cal.tile_length, cm_per_px=cal.cm_per_px, yaw=cal.yaw)
    return cal.with_matrix(m)


__all__ = ["BEVTransform", "toy_calibration"]
