from .metrics import auc_score, log_loss_score
from .trainer import CTRTrainer

__all__ = ["CTRTrainer", "auc_score", "log_loss_score"]
