"""Model evaluation: accuracy / IoU over labelled frames, and bit parity.

Port of ``bugcar_image_segmentation_tpu/evaluation.py`` (the capability
of the reference's missing ``evaluate_model.py``): a per-batch confusion
matrix accumulated on the engine's device, the derived metrics (pixel
accuracy, per-class accuracy and IoU, mean IoU) over raw backbone classes
or the 3-class drivability remap, and a cell-by-cell parity report between
two maps or grids (the instrument of the mask-IoU parity of BASELINE).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from .models.api import Engine


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) int64 counts on ``pred``'s device; rows
    are labels, columns predictions.  Pixels whose label lies outside
    [0, num_classes) (ignore regions) are dropped."""
    pred = torch.as_tensor(pred).reshape(-1).long()
    label = torch.as_tensor(label, device=pred.device).reshape(-1).long()
    valid = (label >= 0) & (label < num_classes)
    idx = torch.where(valid, label * num_classes + pred,
                      num_classes * num_classes)
    flat = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return flat[:-1].reshape(num_classes, num_classes)


@dataclasses.dataclass(frozen=True)
class SegmentationMetrics:
    confusion: np.ndarray

    @property
    def pixel_accuracy(self) -> float:
        total = self.confusion.sum()
        return float(np.trace(self.confusion) / max(total, 1))

    @property
    def per_class_iou(self) -> np.ndarray:
        tp = np.diag(self.confusion).astype(np.float64)
        fp = self.confusion.sum(axis=0) - tp
        fn = self.confusion.sum(axis=1) - tp
        denom = tp + fp + fn
        return np.where(denom > 0, tp / np.maximum(denom, 1), np.nan)

    @property
    def mean_iou(self) -> float:
        iou = self.per_class_iou
        return float(np.nanmean(iou)) if np.isfinite(iou).any() else 0.0

    @property
    def per_class_accuracy(self) -> np.ndarray:
        tp = np.diag(self.confusion).astype(np.float64)
        support = self.confusion.sum(axis=1)
        return np.where(support > 0, tp / np.maximum(support, 1), np.nan)

    def summary(self) -> Dict[str, float]:
        return {
            "pixel_accuracy": self.pixel_accuracy,
            "mean_iou": self.mean_iou,
            **{f"iou_class_{i}": float(v)
               for i, v in enumerate(self.per_class_iou)},
        }


def evaluate_model(engine: Engine,
                   dataset: Iterable[Tuple[np.ndarray, np.ndarray]],
                   remap_labels: bool = True,
                   num_classes: Optional[int] = None,
                   ) -> SegmentationMetrics:
    """Accumulated metrics of ``engine`` over (bgr frame, label map) pairs.

    Labels are backbone class ids; with ``remap_labels`` they go through
    the engine's 3-class table as the predictions do (an id past the table
    reads its last entry, as the JAX gather clamps it), so the metric is
    drivability accuracy / IoU.  ``num_classes`` defaults to 3 (remapped)
    or the engine's class count.
    """
    if num_classes is None:
        num_classes = 3 if remap_labels else engine.cfg.num_classes
    table = torch.as_tensor(engine.remap_table, device=engine.device)
    total = torch.zeros((num_classes, num_classes), dtype=torch.int64,
                        device=engine.device)
    for frame, label in dataset:
        pred = engine.predict(frame)
        label = torch.as_tensor(np.asarray(label), device=engine.device)
        if remap_labels:
            idx = label.long()
            idx = torch.where(idx < 0, idx + len(table), idx)
            label = table[idx.clamp(0, len(table) - 1)]
        total += confusion_matrix(pred, label, num_classes)
    return SegmentationMetrics(confusion=total.cpu().numpy())


def bit_parity(a, b) -> Dict[str, float]:
    """Cell-level parity report between two maps or grids of one shape."""
    a = np.asarray(a)
    b = np.asarray(b)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    mismatch = int((a != b).sum())
    return {
        "total_cells": int(a.size),
        "mismatched_cells": mismatch,
        "parity": 1.0 - mismatch / max(a.size, 1),
    }


__all__ = ["confusion_matrix", "SegmentationMetrics", "evaluate_model",
           "bit_parity"]
