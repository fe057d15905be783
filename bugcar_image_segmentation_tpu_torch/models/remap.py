"""Class-index remapping: backbone classes → drivability classes.

Mirrors ``bugcar_image_segmentation_tpu/models/remap.py`` (reference
models.py:55-58, 78-80): road(0), lane-marking(1) → 1 (road); pavement(2),
vegetation(9) → 0 (flat but not road); everything else → 2 (obstacle);
and the binary ``argmax ∈ road classes`` mask.  On the device the remap
is one table lookup behind the argmax.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from ..ops import device_cache

# Drivability classes (the values the grid builder consumes, grid.py).
FLAT_NON_ROAD = 0
ROAD = 1
OBSTACLE = 2

# The 15-class palette of the ENet model (reference note_label:1-15).
ENET_CLASS_NAMES = (
    "road", "lane_marking", "pavement", "building", "wall", "street_pole",
    "unknown6", "unknown7", "tree", "vegetation", "sky", "pedestrian",
    "car_bus", "motorcycle", "unknown14",
)

ROAD_CLASSES = (0, 1)
FLAT_CLASSES = (2, 9)


def remap_table(num_classes: int = 15,
                road_classes: Sequence[int] = ROAD_CLASSES,
                flat_classes: Sequence[int] = FLAT_CLASSES) -> np.ndarray:
    """uint8 lookup table: backbone class id → drivability class id."""
    table = np.full((num_classes,), OBSTACLE, dtype=np.uint8)
    table[list(flat_classes)] = FLAT_NON_ROAD
    table[list(road_classes)] = ROAD
    return table


def remap_classes(class_map: torch.Tensor,
                  table: np.ndarray | None = None) -> torch.Tensor:
    """Apply the drivability remap to an integer class map (any shape)."""
    if table is None:
        table = remap_table()
    table = tuple(int(v) for v in np.asarray(table, np.uint8))
    return _lut(table, class_map.device)[class_map.long()]


@device_cache(maxsize=16)
def _lut(table: tuple, device: torch.device) -> torch.Tensor:
    return torch.tensor(table, dtype=torch.uint8, device=device)


def logits_to_drivability(logits: torch.Tensor,
                          table: np.ndarray | None = None,
                          channel_axis: int = -1) -> torch.Tensor:
    """argmax over classes (first maximum wins) + 3-class remap → uint8."""
    return remap_classes(torch.argmax(logits, dim=channel_axis), table)


def logits_to_binary_road(logits: torch.Tensor,
                          road_classes: Sequence[int] = ROAD_CLASSES,
                          channel_axis: int = -1) -> torch.Tensor:
    """uint8 {0,1} road mask — reference models.py:70-82 semantics."""
    classes = torch.argmax(logits, dim=channel_axis)
    mask = torch.zeros_like(classes, dtype=torch.bool)
    for c in road_classes:
        mask = mask | (classes == c)
    return mask.to(torch.uint8)


__all__ = [
    "FLAT_NON_ROAD", "ROAD", "OBSTACLE",
    "ENET_CLASS_NAMES", "ROAD_CLASSES", "FLAT_CLASSES",
    "remap_table", "remap_classes",
    "logits_to_drivability", "logits_to_binary_road",
]
