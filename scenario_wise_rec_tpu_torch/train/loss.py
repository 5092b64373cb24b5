"""Loss functions (the JAX package's ``train/loss.py``).

The trainer's loss is BCE on *post-sigmoid probabilities*: the reference
applies ``torch.nn.BCELoss`` to model outputs that are already
probabilities (ctr_trainer.py:56,70). Each log term is clamped at -100 as
torch does, but with the double-``where`` idiom so the gradient is zero and
finite where p is exactly 0 or 1 (f32 sigmoid underflows to 0 below a logit
of about -104); ``torch.nn.BCELoss``'s own backward differs there.

``hinge_loss`` / ``bpr_loss`` port the reference's pairwise losses
(basic/loss_func.py:5-33).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..parallel.mesh import all_reduce_, current_step


def _clamped_log(q: torch.Tensor) -> torch.Tensor:
    """``max(log(q), -100)`` for q > 0 and -100 elsewhere, with a zero
    gradient where q <= 0: log only ever sees a positive surrogate."""
    pos = q > 0
    safe = torch.where(pos, q, torch.ones_like(q))
    return torch.where(pos, torch.clamp_min(torch.log(safe), -100.0),
                       torch.full_like(q, -100.0))


def bce_loss(y_pred_prob: torch.Tensor, y_true: torch.Tensor,
             weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean binary cross entropy on probabilities (torch BCELoss values).

    ``weights``: optional per-example 0/1 mask for padded batches; the mean
    is then over real examples only.

    Inside a mesh step (``parallel.mesh_step``) the batch is this rank's
    rows, and the loss is this rank's share of the global weighted mean:
    its ``sum(per_example w)`` over the ``data`` group's summed ``sum(w)``.
    The shares sum to the global loss, and the dense gradients are summed
    over ``data``; a padded last batch leaves each rank its own count of
    real rows.
    """
    y = y_true.to(torch.float32)
    p = y_pred_prob
    per_example = -(y * _clamped_log(p) + (1.0 - y) * _clamped_log(1.0 - p))
    step = current_step()
    if weights is None and step is None:
        return torch.mean(per_example)
    w = torch.ones_like(per_example) if weights is None else weights.to(torch.float32)
    n = torch.sum(w)
    if step is not None:
        n = all_reduce_(n.detach().clone(), step.group)
    return torch.sum(per_example * w) / torch.clamp_min(n, 1.0)


def hinge_loss(pos_score: torch.Tensor, neg_score: torch.Tensor,
               margin: float = 2.0) -> torch.Tensor:
    """Pairwise hinge (reference loss_func.py:5-17)."""
    return torch.mean(torch.clamp_min(margin - pos_score + neg_score, 0.0))


def bpr_loss(pos_score: torch.Tensor, neg_score: torch.Tensor) -> torch.Tensor:
    """Bayesian personalized ranking (reference loss_func.py:20-33)."""
    return torch.mean(-torch.log(torch.sigmoid(pos_score - neg_score)))
