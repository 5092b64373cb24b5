"""Early stopping on validation AUC with a best-weights snapshot (the JAX
package's ``train/callback.py``; reference basic/callback.py:4-33).

Semantics kept exactly: an improvement resets the counter and snapshots the
weights; training stops after ``patience`` consecutive epochs without one
(the reference's ``trial_counter + 1 < patience`` off-by-one included).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch


class EarlyStopper:
    def __init__(self, patience: int):
        self.patience = patience
        self.trial_counter = 0
        self.best_auc = 0.0
        self.best_weights: Optional[Dict[str, torch.Tensor]] = None

    def stop_training(self, val_auc: float, weights: Dict[str, torch.Tensor]) -> bool:
        """Return True when training should stop.

        ``weights`` is a state dict; on an improvement a copy of every tensor
        is taken on its own device (the live tensors are updated in place by
        the next train step).
        """
        if val_auc > self.best_auc:
            self.best_auc = val_auc
            self.trial_counter = 0
            self.best_weights = {k: v.detach().clone() for k, v in weights.items()}
            return False
        if self.trial_counter + 1 < self.patience:
            self.trial_counter += 1
            return False
        return True
