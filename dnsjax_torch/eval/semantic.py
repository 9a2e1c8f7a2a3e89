"""Semantic segmentation metrics: mIoU, fwIoU, class-average and total
accuracy via confusion matrix.

Counterpart of the reference's per-frame metrics (eval_2d.py:180-212) and
the standalone confusion-matrix evaluator (eval_semantic.py:19-101),
including the "robust" variant that drops classes with almost no ground
truth support.

The port's own copy of dnsjax/eval/semantic.py, equal to it (the port imports nothing of
dnsjax; tests/test_torch_shared.py holds the two together).
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


def confusion_matrix(gt: np.ndarray, pred: np.ndarray, n_class: int) -> np.ndarray:
    gt = np.asarray(gt).reshape(-1).astype(np.int64)
    pred = np.asarray(pred).reshape(-1).astype(np.int64)
    ok = (gt >= 0) & (gt < n_class) & (pred >= 0) & (pred < n_class)
    return np.bincount(
        gt[ok] * n_class + pred[ok], minlength=n_class * n_class
    ).reshape(n_class, n_class)


def semantic_metrics(
    gt: np.ndarray,
    pred: np.ndarray,
    n_class: int,
    mask: Optional[np.ndarray] = None,
    min_support: int = 0,
) -> Dict[str, float]:
    """Returns miou, fwiou, class_avg_acc, total_acc (+ per-class iou array).

    min_support: drop classes with fewer GT pixels than this from the
    averages (reference's robust filtering, eval_semantic.py:70-101).
    """
    if mask is not None:
        gt = np.asarray(gt)[np.asarray(mask, bool)]
        pred = np.asarray(pred)[np.asarray(mask, bool)]
    cm = confusion_matrix(gt, pred, n_class)
    support = cm.sum(1)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp

    denom = tp + fp + fn
    valid = (support > min_support) & (denom > 0)
    iou = np.where(denom > 0, tp / np.maximum(denom, 1), 0.0)
    acc = np.where(support > 0, tp / np.maximum(support, 1), 0.0)
    freq = support / max(support.sum(), 1)

    return {
        "miou": float(iou[valid].mean()) if valid.any() else 0.0,
        "fwiou": float((freq[valid] * iou[valid]).sum() / max(freq[valid].sum(), 1e-12))
        if valid.any()
        else 0.0,
        "class_avg_acc": float(acc[valid].mean()) if valid.any() else 0.0,
        "total_acc": float(tp.sum() / max(cm.sum(), 1)),
        "per_class_iou": iou,
        "n_valid_class": int(valid.sum()),
    }
