"""Evaluation metrics (numpy): F1 and ROC-AUC, as in
``rmm_tpu/utils/metric.py``."""
from __future__ import annotations

import numpy as np


def f1_score(y_true, y_pred, average: str = "binary") -> float:
    """sklearn's binary (class 1) and support-weighted F1."""
    y_true = np.asarray(y_true).reshape(-1)
    y_pred = np.asarray(y_pred).reshape(-1)
    labels = np.unique(np.concatenate([y_true, y_pred]))

    def f1_for(c):
        tp = np.sum((y_pred == c) & (y_true == c))
        fp = np.sum((y_pred == c) & (y_true != c))
        fn = np.sum((y_pred != c) & (y_true == c))
        denom = 2 * tp + fp + fn
        return 2 * tp / denom if denom > 0 else 0.0

    if average == "binary":
        return float(f1_for(1))
    if average == "weighted":
        support = np.array([(y_true == c).sum() for c in labels], dtype=float)
        scores = np.array([f1_for(c) for c in labels])
        total = support.sum()
        return float((scores * support).sum() / total) if total else 0.0
    raise ValueError(average)


def roc_auc(y_true, scores) -> float:
    """Binary ROC-AUC by the rank statistic (Mann-Whitney U) with
    tie-averaged ranks, as ``sklearn.roc_auc_score``; NaN with one class."""
    y = np.asarray(y_true).reshape(-1)
    s = np.asarray(scores).reshape(-1).astype(np.float64)
    n_pos = int((y == 1).sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    _, inv, counts = np.unique(s[order], return_inverse=True,
                               return_counts=True)
    avg_rank = np.cumsum(counts) - (counts - 1) / 2.0
    ranks = np.empty(len(s), dtype=np.float64)
    ranks[order] = avg_rank[inv]
    u = ranks[y == 1].sum() - n_pos * (n_pos + 1) / 2.0
    return float(u / (n_pos * n_neg))
