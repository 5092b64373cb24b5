"""EPNet: scenario-gated embedding personalization.

The JAX package's ``models/epnet.py``: the scenario embedding, concatenated
with a **detached** copy of the agnostic embedding, feeds a GateNU, and the
gate scales the (gradient-carrying) agnostic embedding. So the scenario
table learns only through the gate, and the agnostic table only through
the head.

Quirk preserved: the reference builds its head as ``MLP(agn_dims,
fcn_dims)``, whose second positional parameter is ``output_layer``, so the
"MLP" is a single ``Linear(agn_dims, 1)`` and ``fcn_dims`` is ignored
beyond its truthiness.

EPNet has no ``embedding`` collection of its own (two: ``sce_embedding``
and ``agn_embedding``), so the trainer runs the plain dense step for it.
``apply_fused_eval`` runs everything after the embeddings in one CUDA
kernel (``ops/kernels/gated_infer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.gated_infer import epnet_fused_infer
from ..ops.nn import MLP, GateNU
from .base import Model, model_generator


class EPNet(Model):
    def __init__(self, sce_features, agn_features, fcn_dims, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.sce_features = tuple(sce_features)
        self.agn_features = tuple(agn_features)
        self.sce_embedding = EmbeddingCollection(sce_features, gen)
        self.agn_embedding = EmbeddingCollection(agn_features, gen)
        self.sce_dims = sum_embed_dims(sce_features)
        self.agn_dims = sum_embed_dims(agn_features)
        self.gatenu = GateNU(self.sce_dims + self.agn_dims, self.agn_dims, generator=gen)
        # see the module docstring: fcn_dims is unused, as in the reference
        self.mlp = MLP(self.agn_dims, dims=None, output_layer=bool(fcn_dims), generator=gen)

    def _embed(self, x):
        sce = self.sce_embedding(x, self.sce_features, squeeze_dim=True)
        agn = self.agn_embedding(x, self.agn_features, squeeze_dim=True)
        return sce, agn

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        sce, agn = self._embed(x)
        gate = self.gatenu(torch.cat([sce, agn.detach()], dim=1))
        y = self.mlp(agn * gate, train, w, generator)
        return torch.sigmoid(y)[:, 0]

    @torch.no_grad()
    def fold_eval(self):
        """``(gate_l1, gate_l2, head)``: nothing to fold (no BatchNorm), the
        weights as the kernel takes them."""
        assert self.mlp.output_layer, (
            "epnet fused inference needs the MLP head (fcn_dims built with "
            "output_layer=True); this model was built without one")
        g = self.gatenu
        return ((g.l1.w.detach(), g.l1.b.detach()), (g.l2.w.detach(), g.l2.b.detach()),
                (self.mlp.out.w.detach(), self.mlp.out.b.detach()))

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel, numerically equivalent to
        ``apply(train=False)``. ``w`` is accepted for the uniform trainer
        call: the eval math is per row, so the mask is unused."""
        if folded is None:
            folded = self.fold_eval()
        sce, agn = self._embed(x)
        return epnet_fused_infer(sce, agn, *folded, gemma=self.gatenu.gemma)
