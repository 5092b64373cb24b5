from .callback import EarlyStopper
from .loss import bce_loss, bpr_loss, hinge_loss
from .metrics import auc_score, auc_score_device, log_loss_device, log_loss_score
from .optim import (adam, sorted_dense_adam_init, sorted_dense_adam_update,
                    step_lr)
from .trainer import CTRTrainer

__all__ = ["CTRTrainer", "EarlyStopper", "adam", "auc_score", "auc_score_device",
           "bce_loss", "bpr_loss", "hinge_loss", "log_loss_device", "log_loss_score",
           "sorted_dense_adam_init",
           "sorted_dense_adam_update", "step_lr"]
