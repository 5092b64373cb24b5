"""Evaluation metrics with sklearn-exact semantics (host, numpy).

The reference scores with sklearn ``roc_auc_score`` + ``log_loss``. These
re-implement both in numpy (rank-based AUC with average ranks for ties ==
sklearn's trapezoid ROC integral for binary labels), as the JAX package's
``train/metrics.py`` does, so evaluation needs no sklearn at runtime.
"""

from __future__ import annotations

import numpy as np


def auc_score(y_true, y_score) -> float:
    """Binary ROC-AUC via average ranks (ties handled like sklearn)."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    y_score = np.asarray(y_score, dtype=np.float64).ravel()
    if np.isnan(y_score).any():
        # sklearn raises on NaN input; fail loud instead of silently
        # averaging a NaN tie group (np.unique collapses NaNs)
        raise ValueError("Input contains NaN.")
    n_pos = float(np.sum(y_true == 1))
    n_neg = float(len(y_true) - n_pos)
    if n_pos == 0 or n_neg == 0:
        raise ValueError(
            "Only one class present in y_true. ROC AUC score is not defined."
        )
    order = np.argsort(y_score, kind="mergesort")
    ranks = np.empty(len(y_score), dtype=np.float64)
    sorted_scores = y_score[order]
    # average rank within tie groups: np.unique on the sorted scores yields
    # group ids + sizes in one pass
    _, inv, counts = np.unique(sorted_scores, return_inverse=True,
                               return_counts=True)
    firsts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    avg_rank = firsts + (counts - 1) / 2.0 + 1.0
    ranks[order] = avg_rank[inv]
    pos_rank_sum = float(np.sum(ranks[y_true == 1]))
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def log_loss_score(y_true, y_pred, eps: float = 1e-15) -> float:
    """Binary log loss with sklearn's probability clipping."""
    y_true = np.asarray(y_true, dtype=np.float64).ravel()
    p = np.clip(np.asarray(y_pred, dtype=np.float64).ravel(), eps, 1 - eps)
    return float(-np.mean(y_true * np.log(p) + (1 - y_true) * np.log(1 - p)))
