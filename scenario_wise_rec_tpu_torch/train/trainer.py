"""CTR trainer: the serving subset of the JAX package's ``CTRTrainer``.

``predict``, ``evaluate`` and ``evaluate_multi_domain_loss`` (the
reference's per-domain slicing protocol, the acceptance metric of the
benchmark) run the model's eval forward batch by batch on ``device`` and
score on the host with sklearn-parity AUC/logloss. With
``fused_inference=True`` a model that has ``apply_fused_eval`` (MMOE) runs
everything after the embedding in one CUDA kernel, its BatchNorm folded
once per eval pass.

Training (``fit``, the train steps, the embedding-update modes) arrives
with the next slice of the port; the constructor keeps the JAX signature
and raises ``NotImplementedError`` for options that would change what this
slice does.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.config import resolve_device
from ..data.prefetch import prefetch
from .metrics import auc_score, log_loss_score


class CTRTrainer:
    """General single-task CTR trainer (reference ctr_trainer.py:10-60 API).

    Args:
        model: an ``nn.Module`` exposing ``apply(x, train, w) -> probs``.
        device: where the model and batches live; default ``"cuda"``. With
            no card present this raises unless the caller passes ``"cpu"``.
        fused_inference: ``True`` runs eval through ``apply_fused_eval``.
        prefetch_depth: host batches prepared ahead on a thread (0: none).
        The other arguments are the JAX trainer's. Those of training are
        accepted for its coming port and do nothing yet; ``mesh``,
        ``sparse_embedding_updates=True``, ``fused_inference="auto"`` and
        more than one entry in ``gpus`` raise ``NotImplementedError``.
    """

    def __init__(
        self,
        model,
        data_set_type: str = "dataset",
        optimizer_fn=None,
        optimizer_params: Optional[dict] = None,
        scheduler_fn=None,
        scheduler_params: Optional[dict] = None,
        n_epoch: int = 10,
        earlystop_patience: int = 10,
        device: str = "cuda",
        gpus=None,
        model_path: str = "./",
        seed: int = 0,
        mesh=None,
        sparse_embedding_updates: bool = False,
        sparse_update_impl: str = "occurrence",
        fused_inference=False,  # False | True | "auto"
        donate_buffers: bool = False,
        scan_steps: int = 1,
        prefetch_depth: int = 2,
        sorted_reorder: str = "gather",
        sorted_block_rows: Optional[int] = None,
        sorted_chunk_ids: int = 128,
        sorted_dtype: Optional[str] = None,
        sorted_precision: Optional[str] = None,
        sorted_kernel: Optional[bool] = None,
        resident_gather: str = "step",
    ):
        if mesh is not None:
            raise NotImplementedError("multi-GPU training (mesh) is not ported yet")
        if gpus is not None and len(gpus) > 1:
            raise NotImplementedError("more than one GPU is not ported yet")
        if sparse_embedding_updates:
            raise NotImplementedError(
                "sparse_embedding_updates arrives with the training port")
        if fused_inference == "auto":
            raise NotImplementedError(
                "fused_inference='auto' needs the port's own measured win "
                "table; pass True or False")
        if not isinstance(fused_inference, bool):
            # a stray string like "false"/"off" would otherwise coerce to True
            raise ValueError(
                f"fused_inference must be True, False or 'auto', got "
                f"{fused_inference!r}")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.data_set_type = data_set_type
        self.n_epoch = n_epoch
        self.model_path = model_path
        self.seed = seed
        self._fused_inference = fused_inference and hasattr(model, "apply_fused_eval")
        self.prefetch_depth = max(0, int(prefetch_depth))
        self._eval_step = self._build_eval_step()

    def _build_eval_step(self):
        model = self.model
        if self._fused_inference:
            def step(x, w, folded):
                return model.apply_fused_eval(x, w=w, folded=folded)

            return step

        def step(x, w, folded):
            return model.apply(x, train=False, w=w)

        return step

    def _device_batch(self, x, y, w):
        xb = {k: torch.as_tensor(np.asarray(v), device=self.device)
              for k, v in x.items()}
        yb = None if y is None else torch.as_tensor(
            np.asarray(y, np.float32), device=self.device)
        wb = torch.as_tensor(np.asarray(w), device=self.device)
        return xb, yb, wb

    # ------------------------------------------------------------------

    def _predict_loader(self, data_loader):
        """Run the eval step over a loader; returns (y, p, domain, w) with
        the weight-0 padding rows dropped host-side."""
        ys, ps, ds, ws = [], [], [], []
        with torch.inference_mode():
            # fold once per pass: the weights cannot change inside it
            folded = self.model.fold_eval() if self._fused_inference else None
            for x, y, w in prefetch(data_loader, self.prefetch_depth):
                xb, _, wb = self._device_batch(x, None, w)
                probs = self._eval_step(xb, wb, folded)
                keep = np.asarray(w) > 0
                ps.append(probs.cpu().numpy()[keep])
                if y is not None:
                    ys.append(np.asarray(y)[keep])
                if "domain_indicator" in x:
                    ds.append(np.asarray(x["domain_indicator"])[keep])
                ws.append(np.asarray(w)[keep])
        cat = lambda lst: np.concatenate(lst) if lst else np.array([])
        return cat(ys), cat(ps), cat(ds), cat(ws)

    def evaluate(self, model, data_loader, mode: str = "val",
                 on_device: bool = False):
        """Overall AUC + logloss (reference ctr_trainer.py:99-111)."""
        if on_device:
            raise NotImplementedError("on-device AUC is not ported yet")
        y, p, _, _ = self._predict_loader(data_loader)
        return auc_score(y, p), log_loss_score(y, p)

    def evaluate_multi_domain_loss(self, model, data_loader, domain_num: int,
                                   on_device: bool = False):
        """Per-domain + overall AUC/logloss (reference ctr_trainer.py:113-152).

        Returns ``(domain_logloss[D], domain_auc[D], total_logloss,
        total_auc)`` with ``None`` for empty domains, exactly as reference.
        """
        if on_device:
            raise NotImplementedError("on-device AUC is not ported yet")
        y, p, d, _ = self._predict_loader(data_loader)
        domain_logloss_list, domain_auc_list = [], []
        for dom in range(domain_num):
            m = d == dom
            if m.any():
                domain_logloss_list.append(log_loss_score(y[m], p[m]))
                domain_auc_list.append(auc_score(y[m], p[m]))
            else:
                domain_logloss_list.append(None)
                domain_auc_list.append(None)
        total_logloss = log_loss_score(y, p) if len(p) else None
        total_auc = auc_score(y, p) if len(p) else None
        return domain_logloss_list, domain_auc_list, total_logloss, total_auc

    def predict(self, model, data_loader):
        _, p, _, _ = self._predict_loader(data_loader)
        return list(p)
