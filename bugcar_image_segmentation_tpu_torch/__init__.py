"""PyTorch + CUDA port of ``bugcar_image_segmentation_tpu`` for NVIDIA
Hopper (H100).

The JAX package beside it is the reference; this package imports neither
it nor JAX, Flax, msgpack or cv2.  The ported slices carry the path

  640x480 uint8 BGR frame → bilinear resize (on the device, or on the
  host with ``host_resize=True``, then optionally packed as I420 and
  converted back on the device) → BGR→RGB + ImageNet normalize →
  backbone → argmax + 3-class remap → BEV warp → 3x3 morph-open →
  nearest binning → int8 grid

with the backbone ENet (``"enet"``, or ``"enet_fused"`` with the 16 trunk
bottlenecks as a hand-written CUDA kernel), SegFormer B0-B3
(``"segformer[_bN][_q][_int8][_hc]"``, attention as a hand-written CUDA
kernel), DeepLabV3+ on Xception-65 (``"[deeplab_]xception[_q][_int8][_fs]"``)
or on MobileNetV2 (``"deeplab[_q]"``), or UNet (``"unet"``, ``"unet_ph"``),
any of them with ``_w16`` (weights rounded to bf16); optionally CLAHE
before the backbone, the contour filter after it and a laserscan grid, and
N cameras stitched into one grid (``MultiCameraPipeline``).  After the
grid: temporal fusion (``TemporalGridFusion``), the camera's FOV in cells
(``fov``), the ROS message (``msg``), and the accuracy / IoU and parity
instruments (``evaluation``).  ``bench.py``'s
path is ``build_engine("enet_w16")`` with ``Pipeline(..., host_resize=True,
transport="i420")``.

Layer map:
  ops/        resamplers, the host resize, the I420 transport, pooling,
              morphology, the homography warp, the polar plans, the W8A8
              int8 matmul, ops/cuda/ (kernel wrappers; sources in csrc/)
  geometry    calibration-time homography math (host numpy)
  configs     calibration / grid / model / runtime configs
  models/     ENet and its fused-trunk executor, SegFormer, the Xception
              and MobileNetV2 DeepLabs, UNet, preprocess, remap, Engine
  convert/    Flax variable trees ↔ the port's state dicts
  utils/      the Flax checkpoint reader and writer (no msgpack, no Flax),
              train-state checkpoints
  training/   the loss, AdamW as optax computes it, the train and eval
              steps (train-mode BatchNorm, ENet's dropout), augmentation
  parallel/   meshes of named axes on torch.distributed (gloo on the
              CPU, NCCL on the card): data-parallel, dp x tp and dp x sp
              training, the camera-sharded rig, tensor-parallel and
              spatially partitioned serving
  grid        segmap → occupancy grid (ops/polar.py: laserscan)
  postproc    CLAHE and the contour filter
  pipeline    frame → grid, batched and streaming; the camera rig
  fusion      temporal log-odds evidence over grids (numpy or torch)
  fov         the camera's field of view in grid cells (numpy)
  msg         nav_msgs/OccupancyGrid semantics, ROS-free (numpy)
  evaluation  accuracy / IoU and the bit-parity report
  synthetic   procedural road scenes (numpy)

``deploy`` freezes an engine, a pipeline or the rig into a ``torch.export``
artifact that loads without the model code; ``io`` holds the frame ring
and the camera sources, ``utils.profiling`` the spans and counters the
pipeline, engine and grid record and the profiler trace.

Entry points run on the GPU (``device="cuda"``) unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper runs its plain PyTorch
version.
"""

from . import configs, geometry
from .calibration import BEVTransform
from .configs import CalibrationConfig, GridConfig, ModelConfig, RuntimeConfig
from .fusion import FusionState, TemporalGridFusion, fuse_step

# The model code (models/, convert/, grid, pipeline) loads at the first use
# of one of these names, not with the package: ``deploy.load_artifact``
# runs an exported program with none of it imported.
_LAZY = {"OccupancyGridBuilder": "grid", "create_occupancy_grid": "grid",
         "create_occupancy_grid_binary": "grid", "Engine": "models.api",
         "build_engine": "models.api", "MultiCameraPipeline": "pipeline",
         "Pipeline": "pipeline", "segment_frame": "pipeline",
         "stitch_grids": "pipeline"}


def __getattr__(name: str):
    if name in _LAZY:
        import importlib
        value = getattr(importlib.import_module(f".{_LAZY[name]}", __name__),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__version__ = "0.1.0"

__all__ = [
    "BEVTransform", "CalibrationConfig", "GridConfig", "ModelConfig",
    "RuntimeConfig", "OccupancyGridBuilder", "create_occupancy_grid",
    "create_occupancy_grid_binary", "Pipeline", "MultiCameraPipeline",
    "stitch_grids", "segment_frame", "Engine", "build_engine", "configs",
    "geometry", "FusionState", "TemporalGridFusion", "fuse_step",
]
