"""Evaluation metrics with sklearn-exact semantics.

The reference scores with sklearn ``roc_auc_score`` + ``log_loss``. These
re-implement both in numpy (rank-based AUC with average ranks for ties ==
sklearn's trapezoid ROC integral for binary labels), as the JAX package's
``train/metrics.py`` does, so evaluation needs no sklearn at runtime; and
on torch tensors (:func:`auc_score_device`, :func:`log_loss_device`), so an
eval pass on the card scores without copying its predictions to the host.
"""

from __future__ import annotations

import numpy as np
import torch


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


def auc_score_device(y_true: torch.Tensor, y_score: torch.Tensor,
                     mask: torch.Tensor | None = None) -> torch.Tensor:
    """AUC on the tensors' device: the average-rank formulation, one stable
    sort. Returns a 0-d float32 tensor.

    Matches :func:`auc_score` to float32 precision: ranks and sums are
    float32, as in the JAX package, so above 2^24 rows the ranks stop being
    exact. An optional bool/float ``mask`` restricts the AUC to a subset
    (e.g. one domain) with static shapes: masked-out scores are pushed to
    the sentinel -1.0, below every probability, so subset ranks are global
    ranks minus the masked count (a score of exactly -1.0 would tie with the
    sentinel; callers pass probabilities, which cannot).

    NaN scores are not detected here; the trainer's on-device eval raises on
    them before calling, as the host path does.
    """
    y_true = y_true.float().reshape(-1)
    y_score = y_score.float().reshape(-1)
    n = y_score.shape[0]
    if mask is not None:
        m = mask.float().reshape(-1)
        n_masked = n - m.sum()
        y_score = torch.where(m > 0, y_score, -1.0)
    s, order = torch.sort(y_score, stable=True)
    # each sorted element's rank, averaged over its tie group: the mean of
    # the group's first and last index, 1-based
    idx = torch.arange(n, device=s.device)
    is_start = torch.ones(n, dtype=torch.long, device=s.device)
    is_start[1:] = (s[1:] != s[:-1]).long()
    group_id = torch.cumsum(is_start, 0) - 1
    # the initial values take part (include_self): n above and 0 below every
    # index, as the JAX package's .at[].min / .at[].max over full(n) / zeros
    first = torch.full((n,), n, dtype=idx.dtype, device=s.device).scatter_reduce(
        0, group_id, idx, "amin", include_self=True)
    last = torch.zeros(n, dtype=idx.dtype, device=s.device).scatter_reduce(
        0, group_id, idx, "amax", include_self=True)
    avg_rank_sorted = 0.5 * (first[group_id] + last[group_id]).float() + 1.0
    ranks = torch.zeros(n, dtype=torch.float32, device=s.device).scatter(
        0, order, avg_rank_sorted)
    if mask is None:
        n_pos = y_true.sum()
        n_neg = n - n_pos
        pos_rank_sum = (ranks * y_true).sum()
    else:
        ranks = ranks - n_masked          # subset-local ranks
        n_pos = (y_true * m).sum()
        n_neg = m.sum() - n_pos
        pos_rank_sum = (ranks * y_true * m).sum()
    return (pos_rank_sum - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg)


def log_loss_device(y_true: torch.Tensor, y_pred: torch.Tensor,
                    mask: torch.Tensor | None = None, eps: float = 1e-7) -> torch.Tensor:
    """Binary log loss on the tensors' device (0-d float32); an optional
    subset ``mask`` (static shapes, mean over the subset).

    Clips probabilities at 1e-7 instead of sklearn's 1e-15: in float32
    ``1 - 1e-15 == 1.0``, so the sklearn constant would give ``log(0)`` on
    saturated probabilities. Equal to :func:`log_loss_score` for
    probabilities in [1e-7, 1 - 1e-7]; an exactly saturated float32
    probability scores 16.1 instead of the host's 34.5 (both are clip
    artifacts)."""
    y_true = y_true.float().reshape(-1)
    p = y_pred.float().reshape(-1).clamp(eps, 1 - eps)
    ll = -(y_true * torch.log(p) + (1 - y_true) * torch.log(1 - p))
    if mask is None:
        return ll.mean()
    m = mask.float().reshape(-1)
    return torch.where(m > 0, ll, 0.0).sum() / m.sum()
