"""Evaluation metrics (numpy), as in ``rmm_tpu/utils/metric.py``: F1,
ROC-AUC, and the self-supervised MRR/Hits@k, MCM accuracy/RMSE and the
mask vector's accuracy."""
from __future__ import annotations

from typing import Sequence

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


def mrr(pos_pred, neg_pred, ks: Sequence[int], num_neg_samples: int):
    """MRR and Hits@k of each positive ranked among its own negatives
    (``rmm_tpu``'s ``SSMetric.mrr``): rank = 1 + #{neg ≥ pos}, so a tie
    ranks the positive after the equal negatives."""
    pos = np.asarray(pos_pred).reshape(-1)
    neg = np.asarray(neg_pred).reshape(len(pos), num_neg_samples)
    ranks = 1 + (neg >= pos[:, None]).sum(axis=1)
    hits = {f"hits@{k}": float(np.mean(ranks <= k)) for k in ks}
    return float(np.mean(1.0 / ranks)), hits


def mv_accuracy(mv_out, y) -> float:
    """The share of rows whose mask-vector argmax is the masked column's
    index ``y[:, 1]``."""
    idx = np.asarray(y)[:, 1].astype(int)
    return float(np.mean(np.asarray(mv_out).argmax(axis=1) == idx))


class MCMAccumulator:
    """MCM accuracy (categorical cells) and RMSE (numerical cells), summed
    over batches."""

    def __init__(self, num_numerical: int):
        self.num_numerical = num_numerical
        self.acc_sum = 0.0
        self.l2_sum = 0.0
        self.t_c = 0
        self.t_n = 0

    def update(self, cat_out, num_out, y, valid=None):
        y = np.asarray(y)
        n = len(y) if valid is None else int(valid)
        y = y[:n]
        val = y[:, 0]
        idx = y[:, 1].astype(int)
        num_rows = np.nonzero(idx < self.num_numerical)[0]
        if len(num_rows):
            pred = np.asarray(num_out)[num_rows, idx[num_rows]]
            self.l2_sum += float(((val[num_rows] - pred) ** 2).sum())
            self.t_n += len(num_rows)
        for c, logits in enumerate(cat_out):
            rows = np.nonzero(idx == self.num_numerical + c)[0]
            if not len(rows):
                continue
            pred_cls = np.asarray(logits)[rows].argmax(axis=1)
            self.acc_sum += float((pred_cls == val[rows].astype(int)).sum())
            self.t_c += len(rows)

    @property
    def accuracy(self) -> float:
        return self.acc_sum / max(self.t_c, 1)

    @property
    def rmse(self) -> float:
        return float(np.sqrt(self.l2_sum / max(self.t_n, 1)))
