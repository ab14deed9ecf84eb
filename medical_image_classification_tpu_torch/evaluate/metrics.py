"""Evaluation metric suite: accuracy, macro precision / recall /
specificity / F1 from the confusion matrix, macro one-vs-rest AUC by the
rank statistic (ties take their average rank), the parameter count and
the one-row CSV.

A copy of ``medical_image_classification_tpu/evaluate/metrics.py``
(numpy only), kept here so that the port imports nothing of the JAX
package; ``count_parameters`` counts a torch module's parameters.
"""

from __future__ import annotations

import csv
from typing import Dict, Optional

import numpy as np


def confusion_matrix(y_true, y_pred, num_classes: int) -> np.ndarray:
    cm = np.zeros((num_classes, num_classes), dtype=np.int64)
    np.add.at(cm, (np.asarray(y_true), np.asarray(y_pred)), 1)
    return cm


def _safe_div(a, b):
    return np.divide(a, b, out=np.zeros_like(a, dtype=np.float64),
                     where=b != 0)


def roc_auc_ovr(y_true, scores) -> float:
    """Macro one-vs-rest AUC by the Mann-Whitney rank statistic, tied
    scores at their average rank; a class with no positives or no
    negatives is left out of the mean."""
    y_true = np.asarray(y_true)
    scores = np.asarray(scores, dtype=np.float64)
    aucs = []
    for c in range(scores.shape[1]):
        pos = y_true == c
        n_pos, n_neg = pos.sum(), (~pos).sum()
        if n_pos == 0 or n_neg == 0:
            continue
        _, inv, counts = np.unique(scores[:, c], return_inverse=True,
                                   return_counts=True)
        cum = np.cumsum(counts)
        ranks = (cum - (counts - 1) / 2.0)[inv]
        aucs.append((ranks[pos].sum() - n_pos * (n_pos + 1) / 2)
                    / (n_pos * n_neg))
    return float(np.mean(aucs)) if aucs else float("nan")


def classification_metrics(y_true, y_pred, scores=None,
                           num_classes: Optional[int] = None
                           ) -> Dict[str, float]:
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    nc = num_classes or int(max(y_true.max(), y_pred.max()) + 1)
    cm = confusion_matrix(y_true, y_pred, nc)
    tp = np.diag(cm).astype(np.float64)
    fp = cm.sum(0) - tp
    fn = cm.sum(1) - tp
    tn = cm.sum() - tp - fp - fn
    precision = _safe_div(tp, tp + fp)
    recall = _safe_div(tp, tp + fn)            # sensitivity
    specificity = _safe_div(tn, tn + fp)
    f1 = _safe_div(2 * precision * recall, precision + recall)
    out = {
        "accuracy": float(tp.sum() / max(cm.sum(), 1)),
        "precision_macro": float(precision.mean()),
        "recall_macro": float(recall.mean()),
        "specificity_macro": float(specificity.mean()),
        "f1_macro": float(f1.mean()),
    }
    if scores is not None:
        out["auc_ovr_macro"] = roc_auc_ovr(y_true, scores)
    return out


def count_parameters(model) -> int:
    """The elements of ``model.parameters()``: buffers (BatchNorm running
    statistics, the KAN grids), which the JAX package keeps outside
    ``params``, are not counted."""
    return sum(p.numel() for p in model.parameters())


def metrics_to_csv(path: str, metrics: Dict[str, float],
                   extra: Optional[Dict] = None):
    """One header row and one value row: ``metrics``, then ``extra``."""
    row = dict(metrics)
    if extra:
        row.update(extra)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(row))
        w.writeheader()
        w.writerow(row)
