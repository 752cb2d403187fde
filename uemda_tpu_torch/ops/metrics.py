"""Confusion-matrix pixel metrics.

Port of ``uemda_tpu/ops/metrics.py`` (reference ``PixelMetricIgnore``,
``uemda/gast/metrics.py:19-65``): a (C, C) confusion matrix accumulated on
the device across eval batches, and a host summary whose means drop the
classes in ``ignore_labels`` (IsprsDA drops class 0,
``uemda/utils/eval.py:16-17``).
"""

from typing import List, Optional, Sequence

import numpy as np
import torch


def confusion_matrix(y_true: torch.Tensor, y_pred: torch.Tensor,
                     num_classes: int,
                     valid_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Dense (C, C) int64 matrix; rows = true class, cols = predicted.
    Pixels with y_true < 0 or a False ``valid_mask`` are dropped (counted
    in a spill bin past the matrix). The counts go into a fixed ``C*C + 1``
    buffer with ``index_add_``: no host synchronisation, where
    ``torch.bincount`` on the card reads the input's maximum back to size
    its output."""
    t = y_true.reshape(-1).long()
    p = y_pred.reshape(-1).long()
    valid = t >= 0
    if valid_mask is not None:
        valid = valid & valid_mask.reshape(-1)
    n = num_classes * num_classes
    idx = torch.where(valid, t * num_classes + p, torch.full_like(t, n))
    counts = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
    counts.index_add_(0, idx, idx.new_ones(()).expand_as(idx))
    return counts[:-1].reshape(num_classes, num_classes)


def _diag(cm: np.ndarray) -> np.ndarray:
    return np.diag(cm).astype(np.float64)


def iou_per_class(cm: np.ndarray) -> np.ndarray:
    cm = np.asarray(cm, np.float64)
    inter = _diag(cm)
    union = cm.sum(0) + cm.sum(1) - inter
    return inter / np.maximum(union, 1e-10)


def precision_per_class(cm: np.ndarray) -> np.ndarray:
    cm = np.asarray(cm, np.float64)
    return _diag(cm) / np.maximum(cm.sum(0), 1e-10)


def recall_per_class(cm: np.ndarray) -> np.ndarray:
    cm = np.asarray(cm, np.float64)
    return _diag(cm) / np.maximum(cm.sum(1), 1e-10)


def f1_per_class(cm: np.ndarray, beta: float = 1.0) -> np.ndarray:
    p = precision_per_class(cm)
    r = recall_per_class(cm)
    b2 = beta * beta
    return (1 + b2) * p * r / np.maximum(b2 * p + r, 1e-10)


class PixelMetricSummary:
    """Host-side summary over an accumulated confusion matrix."""

    def __init__(self, num_classes: int,
                 class_names: Optional[Sequence[str]] = None,
                 ignore_labels: Optional[List[int]] = None, dec: int = 5):
        self.num_classes = num_classes
        self.class_names = list(class_names) if class_names else None
        self.ignore_labels = sorted(ignore_labels or [], reverse=True)
        self.dec = dec

    def summarize(self, cm) -> dict:
        if isinstance(cm, torch.Tensor):
            cm = cm.cpu().numpy()
        cm = np.asarray(cm, np.float64)
        iou = np.round(iou_per_class(cm), self.dec).tolist()
        f1 = np.round(f1_per_class(cm), self.dec).tolist()
        prec = np.round(precision_per_class(cm), self.dec).tolist()
        rec = np.round(recall_per_class(cm), self.dec).tolist()
        names = list(self.class_names) if self.class_names else [
            str(i) for i in range(self.num_classes)
        ]
        for idx in self.ignore_labels:
            for lst in (iou, f1, prec, rec, names):
                lst.pop(idx)
        return {
            "class_names": names,
            "iou": iou,
            "f1": f1,
            "precision": prec,
            "recall": rec,
            "miou": float(np.round(np.mean(iou), self.dec)),
            "mf1": float(np.round(np.mean(f1), self.dec)),
            "mprecision": float(np.round(np.mean(prec), self.dec)),
            "mrecall": float(np.round(np.mean(rec), self.dec)),
        }

    def format_table(self, summary: dict) -> str:
        rows = [f"{'name':>12} {'iou':>9} {'f1':>9} {'prec':>9} {'recall':>9}"]
        for i, name in enumerate(summary["class_names"]):
            rows.append(
                f"{name:>12} {summary['iou'][i]:>9.5f} {summary['f1'][i]:>9.5f}"
                f" {summary['precision'][i]:>9.5f} {summary['recall'][i]:>9.5f}"
            )
        rows.append(
            f"{'mean':>12} {summary['miou']:>9.5f} {summary['mf1']:>9.5f}"
            f" {summary['mprecision']:>9.5f} {summary['mrecall']:>9.5f}"
        )
        return "\n".join(rows)
