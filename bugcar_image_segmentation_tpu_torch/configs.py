"""Configuration dataclasses of the PyTorch port (mirrors
``bugcar_image_segmentation_tpu/configs.py``; a copy, so the port never
imports the JAX package).


The reference scattered its configuration across three mechanisms: class
constants on the model classes (reference models.py:15-19, 100-103), a
calibration JSON written/read by ``bev_transform_tools`` (reference
bev.py:24-56), and hard-coded paths.  Here everything is a frozen dataclass
with explicit JSON (de)serialization.

``CalibrationConfig`` round-trips the *reference's* JSON schema exactly
(keys at reference bev.py:47-55) and fixes the reference's asymmetry where
``fromJSON`` required an ``is_laserscan`` key (bev.py:37) that
``save_to_JSON`` never wrote — we both write it and tolerate its absence.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# Calibration
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Static geometry of the camera → bird's-eye-view transform.

    Mirrors the state held by the reference's ``bev_transform_tools``
    (reference bev.py:13-22):

    - ``input_shape``:  (width, height) of the segmentation map fed to the
      grid builder.
    - ``output_shape``: (width, height) of the warped BEV image.
    - ``dist2target``:  (x, y) distance in cm from the camera to the
      calibration fiducial target (x horizontal, y along the ground).
    - ``tile_length``:  physical edge length of the fiducial tile in cm.
    - ``cm_per_px``:    BEV scale, centimetres per BEV pixel.
    - ``yaw``:          fiducial yaw in radians.
    - ``laserscan``:    emit laserscan-like grids (first obstacle per ray).
    - ``matrix``:       the 3x3 homography (input pixel → BEV pixel), or
      ``None`` before calibration.
    """

    input_shape: Tuple[int, int]
    output_shape: Tuple[int, int]
    dist2target: Tuple[float, float]
    tile_length: float
    cm_per_px: float
    yaw: float
    laserscan: bool = False
    matrix: Optional[Tuple[Tuple[float, ...], ...]] = None

    # -- accessors ---------------------------------------------------------

    @property
    def input_width(self) -> int:
        return int(self.input_shape[0])

    @property
    def input_height(self) -> int:
        return int(self.input_shape[1])

    @property
    def output_width(self) -> int:
        return int(self.output_shape[0])

    @property
    def output_height(self) -> int:
        return int(self.output_shape[1])

    def matrix_np(self) -> np.ndarray:
        if self.matrix is None:
            raise ValueError("CalibrationConfig has no homography matrix yet; "
                             "run calibration or load one from JSON.")
        m = np.asarray(self.matrix, dtype=np.float64)
        if m.shape != (3, 3):
            raise ValueError(f"bev matrix must be 3x3, got {m.shape}")
        return m

    def with_matrix(self, matrix: np.ndarray) -> "CalibrationConfig":
        m = np.asarray(matrix, dtype=np.float64).reshape(3, 3)
        return dataclasses.replace(self, matrix=tuple(map(tuple, m.tolist())))

    # -- reference-schema JSON interop --------------------------------------
    # Keys must match reference bev.py:47-55 so calibration files are
    # interchangeable between the two stacks.

    def to_reference_dict(self) -> dict:
        return {
            "input image size": list(self.input_shape),
            "output image size": list(self.output_shape),
            "bev matrix": self.matrix_np().tolist(),
            "distance to target": list(self.dist2target),
            "tile_length": self.tile_length,
            "cm_per_px": self.cm_per_px,
            "yaw": self.yaw,
            # The reference's save_to_JSON omitted this key even though its
            # fromJSON required it (reference bev.py:37 vs :47-55).  We
            # always write it so saved files reload cleanly everywhere.
            "is_laserscan": bool(self.laserscan),
        }

    @classmethod
    def from_reference_dict(cls, data: dict) -> "CalibrationConfig":
        matrix = np.reshape(np.asarray(data["bev matrix"], dtype=np.float64),
                            (3, 3))
        return cls(
            input_shape=tuple(int(v) for v in data["input image size"]),
            output_shape=tuple(int(v) for v in data["output image size"]),
            dist2target=tuple(float(v) for v in data["distance to target"]),
            tile_length=float(data["tile_length"]),
            cm_per_px=float(data["cm_per_px"]),
            yaw=float(data["yaw"]),
            # Tolerate files written by the reference (key absent).
            laserscan=bool(data.get("is_laserscan", False)),
            matrix=tuple(map(tuple, matrix.tolist())),
        )

    def save_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_reference_dict(), f)

    @classmethod
    def load_json(cls, path: str) -> "CalibrationConfig":
        with open(path, "r") as f:
            return cls.from_reference_dict(json.load(f))


# ---------------------------------------------------------------------------
# Occupancy grid geometry
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Metric occupancy-grid geometry.

    Mirrors the per-call arguments of the reference's grid builders
    (reference bev.py:166-167): grid width/height in metres and cell size in
    metres.  All derived pixel quantities (reference bev.py:172-176) are
    exposed as properties so the device path and tests share one source of
    truth.
    """

    width_m: float
    height_m: float
    cell_m: float

    def cell_px(self, cm_per_px: float) -> float:
        return self.cell_m * 100.0 / cm_per_px

    @property
    def cells_w(self) -> int:
        return int(self.width_m / self.cell_m)

    @property
    def cells_h(self) -> int:
        return int(self.height_m / self.cell_m)

    def template_px(self, cm_per_px: float) -> Tuple[int, int]:
        """(width_px, height_px) of the pre-binning BEV template."""
        cpx = self.cell_px(cm_per_px)
        return int(self.cells_w * cpx), int(self.cells_h * cpx)


# ---------------------------------------------------------------------------
# Model / runtime
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Which backbone to run and at what resolution.

    Defaults follow the reference's ENet constants (reference
    models.py:15-19): 512x256 input, ImageNet statistics, 15 classes
    (reference note_label:1-15).
    """

    name: str = "enet"
    input_width: int = 512
    input_height: int = 256
    num_classes: int = 15
    image_mean: Tuple[float, float, float] = (0.485, 0.456, 0.406)
    image_std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
    # Activation dtype; parameters are kept in float32.
    dtype: str = "bfloat16"


@dataclasses.dataclass(frozen=True)
class RuntimeConfig:
    """Streaming-loop knobs."""

    batch_size: int = 1
    num_cameras: int = 1
    # Depth of the async dispatch pipeline (frames in flight).
    pipeline_depth: int = 2
    # Interpolation used when warping the class map to BEV:
    #   "cv2_linear"  — bit-matches cv2.warpPerspective INTER_LINEAR on label
    #                   maps (the reference's behaviour, bev.py:182, which
    #                   interpolates class *ids*).
    #   "nearest"     — semantically correct for label maps.
    warp_interpolation: str = "cv2_linear"
    donate_input: bool = True


__all__ = [
    "CalibrationConfig",
    "GridConfig",
    "ModelConfig",
    "RuntimeConfig",
]
