"""AdaSparse: scenario-conditioned pruning of MLP activations.

The JAX package's ``models/adasparse.py``:

- a Pruner on ``[sce ‖ agn]`` multiplies the agnostic embedding, and one
  after each hidden layer (Linear -> masked BatchNorm -> act -> dropout)
  multiplies its activation; a final Linear and the sigmoid;
- ``alpha`` sharpens the Binarization and Fusion pruners. It is a
  registered buffer, not a parameter: every train-mode forward advances it
  by ``delta_alpha`` in place (after using it), an eval forward never does,
  as the JAX package carries it in its model state.

AdaSparse has no ``embedding`` collection of its own, so the trainer runs
the plain dense step for it. ``apply_fused_eval`` runs everything after the
embeddings in one CUDA kernel (``ops/kernels/gated_infer.py``), with the
BatchNorms and ``alpha`` folded into the weights outside it.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.activations import activation as activation_factory
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_layers_eval
from ..ops.kernels.gated_infer import adasparse_fused_infer
from ..ops.nn import Linear, Pruner, _Layer, dropout
from .base import Model, model_generator


class AdaSparse(Model):
    def __init__(self, sce_features, agn_features, mlp_params, form: str = "Fusion",
                 epsilon: float = 1e-2, beta: float = 2.0, alpha: float = 1.0,
                 delta_alpha: float = 1e-4, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.sce_features = tuple(sce_features)
        self.agn_features = tuple(agn_features)
        self.delta_alpha = float(delta_alpha)
        self.sce_dims = S = sum_embed_dims(sce_features)
        self.agn_dims = sum_embed_dims(agn_features)
        self.sce_embedding = EmbeddingCollection(sce_features, gen)
        self.agn_embedding = EmbeddingCollection(agn_features, gen)
        self.mlp_dims = list(mlp_params.get("dims") or [])
        self.act = activation_factory(mlp_params.get("activation", "relu"))
        self.dropout_p = float(mlp_params.get("dropout", 0.0))
        prune_kw = dict(form=form, epsilon=epsilon, beta=beta, generator=gen)
        # pruner 0 acts on the agnostic embedding; pruner i + 1 on hidden i
        pruners = [Pruner(S, self.agn_dims, **prune_kw)]
        layers, in_dim = [], S + self.agn_dims
        for d in self.mlp_dims:
            layers.append(_Layer(in_dim, d, self.act, gen, ()))
            pruners.append(Pruner(S, d, **prune_kw))
            in_dim = d
        self.layers = nn.ModuleList(layers)
        self.pruners = nn.ModuleList(pruners)
        self.final = Linear(in_dim, 1, gen)
        self.register_buffer("alpha", torch.tensor(float(alpha), device=gen.device))

    def _embed(self, x):
        sce = self.sce_embedding(x, self.sce_features, squeeze_dim=True)
        agn = self.agn_embedding(x, self.agn_features, squeeze_dim=True)
        return sce, agn

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        alpha = self.alpha.clone()
        if train:
            with torch.no_grad():
                self.alpha.add_(self.delta_alpha)
        sce, agn = self._embed(x)
        agn = self.pruners[0](sce, agn, alpha) * agn
        h = torch.cat([sce, agn], dim=1)
        for layer, pruner in zip(self.layers, self.pruners[1:]):
            h = layer.bn(layer.lin(h), train, w)
            h = dropout(self.act.apply(dict(layer.act), h), self.dropout_p, train, generator)
            h = pruner(sce, h, alpha) * h
        return torch.sigmoid(self.final(h))[:, 0]

    @torch.no_grad()
    def fold_eval(self):
        """``(pruner_ws, layer_stages, final)``: ``alpha`` folded into the
        Binarization and Fusion pruner weights (``x (W alpha)`` for ``(x W)
        alpha``), each layer's BatchNorm into its Linear; valid until the
        weights, the running stats or ``alpha`` change."""
        scale = 1.0 if self.pruners[0].form == "Scaling" else self.alpha
        return ([p.w * scale for p in self.pruners], fold_layers_eval(self.layers),
                (self.final.w.detach(), self.final.b.detach()))

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel: equal to
        ``apply(train=False)`` up to float reassociation at the hard
        threshold (alpha is folded into the weights, so a row whose pruner
        input lies within rounding of ``epsilon`` may flip a factor). ``w``
        is accepted for the uniform trainer call: the eval math is per row,
        so the mask is unused."""
        assert self.act.name == "relu"
        if folded is None:
            folded = self.fold_eval()
        p = self.pruners[0]
        sce, agn = self._embed(x)
        return adasparse_fused_infer(sce, agn, *folded, form=p.form, epsilon=p.epsilon,
                                     beta=p.beta)
