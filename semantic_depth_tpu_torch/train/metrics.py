"""Streaming mean IoU with ``tf.metrics.mean_iou`` semantics (port of
``semantic_depth_tpu/train/metrics.py``).

A running confusion matrix accumulates over batches; the mean IoU averages
the per-class IoU over the classes whose denominator is non-zero. Counts are
float32, as in the JAX package, and exact below 2^24 a cell.
"""

from __future__ import annotations

import torch


def confusion_matrix(labels: torch.Tensor, predictions: torch.Tensor,
                     num_classes: int) -> torch.Tensor:
    """(num_classes, num_classes) float32 counts; rows are labels, columns
    predictions (``tf.math.confusion_matrix``)."""
    idx = labels.reshape(-1).long() * num_classes + predictions.reshape(-1).long()
    counts = torch.bincount(idx, minlength=num_classes * num_classes)
    return counts.reshape(num_classes, num_classes).float()


def mean_iou_from_cm(cm: torch.Tensor) -> torch.Tensor:
    """Per-class IoU = diag / (row + col - diag); classes with a zero
    denominator are left out of the mean."""
    diag = torch.diagonal(cm)
    denom = cm.sum(0) + cm.sum(1) - diag
    valid = denom > 0
    # torch.div: a true division, as JAX's (not a reciprocal and a multiply)
    iou = torch.where(valid, torch.div(diag, torch.where(valid, denom, 1.0)), 0.0)
    n_valid = valid.float().sum()
    return torch.where(n_valid > 0, torch.div(iou.sum(), n_valid.clamp(min=1.0)), 0.0)


class MeanIoU:
    """Host accumulator: ``update`` with each batch, then ``result``."""

    def __init__(self, num_classes: int):
        self.num_classes = num_classes
        self.reset()

    def update(self, labels, predictions) -> None:
        self.cm = self.cm + confusion_matrix(
            torch.as_tensor(labels), torch.as_tensor(predictions), self.num_classes).cpu()

    def result(self) -> float:
        return float(mean_iou_from_cm(self.cm))

    def reset(self) -> None:
        self.cm = torch.zeros((self.num_classes, self.num_classes), dtype=torch.float32)
