"""Drop-in compatibility layer: the reference's names and signatures on the
PyTorch port.

Port of ``bugcar_image_segmentation_tpu/compat.py``.  A user of the
reference (tranqkhue/bugcar_image_segmentation) switches imports and keeps
their calling code:

    from bugcar_image_segmentation_tpu_torch.compat import (
        ENET, DeepLabV3, bev_transform_tools,
        convert_to_occupancy_grid_msg, contour_noise_removal, clahe,
        find_intersection_line, order_points_counter_clockwise, testDevice)

Mapping (reference → here):
  models.py ENET / DeepLabV3 (frozen-graph sessions) → the port's
    engines; a ``.pb`` path is converted on load where TensorFlow is
    installed (``convert/tf_graphdef.py``), otherwise the engine starts
    from seeded weights with a warning (the reference ships no weight
    blobs).
  bev.py bev_transform_tools → the calibration and the grid builders
    behind the same method names and signature quirks.
  occgrid_to_ros.py convert_to_occupancy_grid_msg → ``msg.py`` (the
    ROS-free message; ``msg.to_rospy_msg`` makes a rospy object).
  image_processing_utils.py / utils.py helpers → ``postproc`` /
    ``geometry``.

Everything runs on the card unless asked otherwise: the classes and the
device-side helpers take a keyword-only ``device`` ("cuda" by default).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Optional

import numpy as np
import torch

from . import geometry, postproc
from .calibration import BEVTransform
from .configs import GridConfig, ModelConfig
from .grid import OccupancyGridBuilder
from .models import preprocess as pre
from .models import remap
from .models.api import build_engine
from .msg import to_occupancy_grid_msg
from .utils import get_logger, probe_cameras

_log = get_logger("compat")


# ---------------------------------------------------------------------------
# Model engines (reference models.py)
# ---------------------------------------------------------------------------


class _FrozenGraphEngine:
    """Shared loader: a reference-style constructor around an Engine."""

    _MODEL = "enet"
    _CFG = ModelConfig()

    def __init__(self, pb_path: Optional[str] = None, *, device="cuda"):
        variables = None
        if pb_path and os.path.exists(pb_path):
            try:
                from .convert.tf_graphdef import convert_frozen_graph
                cfg = dataclasses.replace(self._CFG, dtype="float32")
                probe = build_engine(self._MODEL, cfg, device="cpu")
                variables = convert_frozen_graph(
                    pb_path, probe.module,
                    np.zeros((1, cfg.input_height, cfg.input_width, 3),
                             np.float32))
            except Exception as e:  # depends on TF and the blob
                warnings.warn(f"could not convert {pb_path!r} ({e}); "
                              "using initialized weights")
        elif pb_path:
            warnings.warn(f"{pb_path!r} not found (the reference snapshot "
                          "ships no weight blobs); using initialized "
                          "weights")
        self.engine = build_engine(self._MODEL, self._CFG,
                                   variables=variables, device=device)

    # Reference contract (models.py:84-95): preprocess a BGR frame into
    # the batched model input.
    def preprocess(self, bgr_frame) -> torch.Tensor:
        x = pre.preprocess_for_config(
            torch.as_tensor(np.asarray(bgr_frame), device=self.engine.device),
            self.engine.cfg)
        return x[None] if x.dim() == 3 else x

    @torch.no_grad()
    def _labels(self, preprocessed, to_labels) -> np.ndarray:
        x = torch.as_tensor(preprocessed, device=self.engine.device)
        out = self.engine.to_input_res(to_labels(self.engine.forward_fn(x)))
        out = out.cpu().numpy()
        return out[0] if out.shape[0] == 1 else out

    # Reference contract (models.py:42-69): preprocessed batch → uint8
    # 3-class drivability map (squeezed like the reference's output).
    def predict(self, preprocessed) -> np.ndarray:
        return self._labels(preprocessed, lambda y: remap.
                            logits_to_drivability(y, self.engine.remap_table))

    # Reference contract (models.py:70-82): {0,1} uint8 road mask.
    def predict_binary(self, preprocessed) -> np.ndarray:
        return self._labels(preprocessed, remap.logits_to_binary_road)


class ENET(_FrozenGraphEngine):
    """Reference models.py:14-95 (enet.pb, 512x256, 15 classes)."""

    _MODEL = "enet"
    _CFG = ModelConfig()
    INPUT_WIDTH = 512
    INPUT_HEIGHT = 256
    IMAGE_MEAN = np.array([0.485, 0.456, 0.406])
    IMAGE_STD = np.array([0.229, 0.224, 0.225])

    def __init__(self, pb_path: str = "./pretrained_models/enet.pb", *,
                 device="cuda"):
        super().__init__(pb_path, device=device)


class DeepLabV3(_FrozenGraphEngine):
    """Reference models.py:98-136 (deeplab.pb, long edge 1024).

    The reference's engine returned the already-argmaxed semantic map and
    its ``preprocess`` was dead code; here ``predict`` takes a raw BGR
    image (as the reference's did, models.py:115-125) and the class map
    comes back at input resolution.
    """

    _MODEL = "deeplab"
    _CFG = ModelConfig(name="deeplab", input_width=1024, input_height=512)
    INPUT_SIZE = 1024
    FROZEN_GRAPH_NAME = "deeplab.pb"

    def __init__(self, pb_path: str = "./pretrained_models/deeplab.pb", *,
                 device="cuda"):
        super().__init__(pb_path, device=device)

    def predict(self, bgr_image) -> np.ndarray:
        return self.engine.predict(np.asarray(bgr_image)).cpu().numpy()


# ---------------------------------------------------------------------------
# BEV transform (reference bev.py)
# ---------------------------------------------------------------------------


class bev_transform_tools(BEVTransform):
    """Reference bev.py:8-92 method surface on the port's grid builders.

    ``create_occupancy_grid(segmap, w_m, h_m, cell_m)`` and the binary
    variant keep the reference's per-call signatures (bev.py:97, 166) and
    its laserscan tuple-return quirk (bev.py:164); the grids are built on
    ``device`` and come back as numpy.
    """

    def __init__(self, *args, device="cuda", **kwargs):
        super().__init__(*args, **kwargs)
        self.device = device

    @classmethod
    def from_json(cls, path: str, *, device="cuda") -> "bev_transform_tools":
        out = super().from_json(path)
        out.device = device
        return out

    fromJSON = from_json

    def _builder(self, grid: GridConfig, mode: str) -> OccupancyGridBuilder:
        key = (grid, mode, self.config.matrix, str(self.device))
        cache = self.__dict__.setdefault("_builders", {})
        if key not in cache:
            cache[key] = OccupancyGridBuilder(self.config, grid, mode=mode,
                                              device=self.device)
        return cache[key]

    def _grid(self, segmap, mode: str, width_m, height_m, cell_m):
        grid = GridConfig(float(width_m), float(height_m), float(cell_m))
        out = self._builder(grid, mode)(np.asarray(segmap))
        if isinstance(out, tuple):
            return tuple(o.cpu().numpy() for o in out)
        return out.cpu().numpy()

    def create_occupancy_grid(self, segmap, occupancy_grid_width_in_m,
                              occupancy_grid_height_in_m, cell_size_in_m):
        return self._grid(segmap, "multiclass", occupancy_grid_width_in_m,
                          occupancy_grid_height_in_m, cell_size_in_m)

    def create_occupancy_grid_binary(self, segmap,
                                     occupancy_grid_width_in_m,
                                     occupancy_grid_height_in_m,
                                     cell_size_in_m):
        return self._grid(segmap, "binary", occupancy_grid_width_in_m,
                          occupancy_grid_height_in_m, cell_size_in_m)


# ---------------------------------------------------------------------------
# Image-processing + utils helpers (reference image_processing_utils.py /
# utils.py)
# ---------------------------------------------------------------------------


def contour_noise_removal(segmap, *, device="cuda") -> np.ndarray:
    """Reference image_processing_utils.py:4-44, on ``device``."""
    mask = torch.as_tensor(np.asarray(segmap, dtype=np.uint8), device=device)
    return postproc.contour_noise_removal(mask).cpu().numpy()


def clahe(img, *, device="cuda") -> np.ndarray:
    """Reference image_processing_utils.py:46-61, on ``device``."""
    return postproc.clahe(torch.as_tensor(np.asarray(img), device=device)
                          ).cpu().numpy()


find_intersection_line = geometry.find_intersection_line
order_points_counter_clockwise = geometry.order_points_counter_clockwise


def testDevice(max_index: int = 10) -> None:
    """Reference utils.py:86-90: warn about unopenable camera sources
    (``probe_cameras`` needs cv2)."""
    available = set(probe_cameras(max_index))
    for i in range(max_index):
        if i not in available:
            _log.warning("Warning: unable to open video source: %s", i)


def freeze_session(variables, path, num_classes=15, input_hw=(256, 512)):
    """Reference utils.py:49-83's train → deploy bridge: a trained port
    ENet (or its Flax-layout tree) → the frozen ``.pb`` the reference
    serves (``input0:0`` NCHW → ``CATkrIDy/concat:0``, weights folded to
    constants, device placements cleared).  Returns the GraphDef; needs
    TensorFlow (``convert/tf_enet.py``)."""
    from .convert.tf_enet import export_enet_pb

    return export_enet_pb(variables, num_classes, input_hw, path)


# Reference occgrid_to_ros.py:13: the same positional signature; returns
# the ROS-free message (msg.to_rospy_msg makes a rospy one).
convert_to_occupancy_grid_msg = to_occupancy_grid_msg


__all__ = [
    "ENET", "DeepLabV3", "bev_transform_tools",
    "convert_to_occupancy_grid_msg", "contour_noise_removal", "clahe",
    "find_intersection_line", "order_points_counter_clockwise",
    "testDevice", "freeze_session",
]
