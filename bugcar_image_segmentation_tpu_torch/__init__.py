"""PyTorch + CUDA port of ``bugcar_image_segmentation_tpu`` for NVIDIA
Hopper (H100).

The JAX package beside it is the reference; this package imports neither
it nor JAX, Flax, msgpack or cv2.  This slice carries the main path:

  640x480 uint8 BGR frame → device-side bilinear resize → BGR→RGB +
  ImageNet normalize → ENet (``"enet"``, or ``"enet_fused"`` with the 16
  trunk bottlenecks as a hand-written CUDA kernel) → argmax + 3-class
  remap → BEV warp → 3x3 morph-open → nearest binning → int8 grid

Layer map:
  ops/        resamplers, pooling, morphology, the homography warp,
              ops/cuda/ (kernel wrappers; sources in csrc/)
  geometry    calibration-time homography math (host numpy)
  configs     calibration / grid / model configs (reference JSON schema)
  models/     ENet, its fused-trunk executor, preprocess, remap, Engine
  convert/    Flax variable tree → the port's state dicts
  grid        segmap → occupancy grid
  pipeline    frame → grid, batched and streaming
  synthetic   procedural road scenes (numpy)

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""

from . import configs, geometry
from .calibration import BEVTransform
from .configs import CalibrationConfig, GridConfig, ModelConfig, RuntimeConfig
from .grid import OccupancyGridBuilder
from .models.api import Engine, build_engine
from .pipeline import Pipeline

__version__ = "0.1.0"

__all__ = [
    "BEVTransform", "CalibrationConfig", "GridConfig", "ModelConfig",
    "RuntimeConfig", "OccupancyGridBuilder", "Pipeline", "Engine",
    "build_engine", "configs", "geometry",
]
