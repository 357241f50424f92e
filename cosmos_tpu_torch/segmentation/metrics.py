"""Segmentation metrics (counterpart of ``cosmos_tpu/segmentation/
metrics.py``): mmseg's IoUMetric, intersections and unions summed over the
dataset with ignore_index 255, giving mIoU, aAcc and mAcc; and mmseg's
reduce_zero_label (label 0 becomes ignore, the others shift down by one).
Host-side numpy: the labels come to the host as int arrays.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict

import numpy as np

IGNORE_INDEX = 255


def reduce_zero_label(label: np.ndarray) -> np.ndarray:
    """0 -> ignore, k -> k-1 (mmseg reduce_zero_label)."""
    out = label.astype(np.int32) - 1
    out[label == 0] = IGNORE_INDEX
    out[label == IGNORE_INDEX] = IGNORE_INDEX
    return out


@dataclass
class IoUMetric:
    num_classes: int
    ignore_index: int = IGNORE_INDEX
    intersect: np.ndarray = field(default=None)
    union: np.ndarray = field(default=None)
    pred_area: np.ndarray = field(default=None)
    label_area: np.ndarray = field(default=None)

    def __post_init__(self):
        z = np.zeros(self.num_classes, np.float64)
        self.intersect = z.copy()
        self.union = z.copy()
        self.pred_area = z.copy()
        self.label_area = z.copy()

    def update(self, pred: np.ndarray, label: np.ndarray) -> None:
        mask = label != self.ignore_index
        pred = pred[mask]
        label = label[mask]
        inter = pred[pred == label]
        self.intersect += np.bincount(inter, minlength=self.num_classes)[
            : self.num_classes
        ]
        self.pred_area += np.bincount(pred, minlength=self.num_classes)[
            : self.num_classes
        ]
        self.label_area += np.bincount(label, minlength=self.num_classes)[
            : self.num_classes
        ]
        self.union = self.pred_area + self.label_area - self.intersect

    def compute(self) -> Dict[str, float]:
        iou = np.where(self.union > 0, self.intersect / np.maximum(self.union, 1), np.nan)
        acc = np.where(
            self.label_area > 0,
            self.intersect / np.maximum(self.label_area, 1),
            np.nan,
        )
        return {
            "mIoU": float(np.nanmean(iou) * 100),
            "aAcc": float(self.intersect.sum() / max(self.label_area.sum(), 1) * 100),
            "mAcc": float(np.nanmean(acc) * 100),
        }
