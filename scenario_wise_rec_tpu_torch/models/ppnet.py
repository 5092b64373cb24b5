"""PPNet: per-domain towers with GateNU-modulated hidden layers.

The JAX package's ``models/ppnet.py``:

- the gate input is the id-feature embedding ‖ a **detached** copy of the
  agnostic embedding;
- each tower layer is ``hidden = MLP_i(hidden) * GateNU_i(gate_input)``, a
  one-layer MLP (Linear -> BatchNorm -> relu) and a gate that both read
  from the gate input; quirk preserved: the tower's *input* is the gate
  input too, not the agnostic embedding, so the agnostic table reaches the
  loss only through ``detach`` and has no gradient at all (the trainer
  still steps it, through its weight decay, as the JAX package does);
- the ``D`` towers are one stack on a leading domain axis (``MLP`` and
  ``GateNU`` with ``members=D``, the final Linear with ``lead=(D,)``), and
  each row selects its own domain's output.

PPNet has no ``embedding`` collection of its own, so the trainer runs the
plain dense step for it. ``apply_fused_eval`` runs everything after the
embeddings in one CUDA kernel (``ops/kernels/gated_infer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_stacked_mlp_eval
from ..ops.kernels.gated_infer import ppnet_fused_infer
from ..ops.nn import MLP, GateNU, Linear
from ..ops.select import domain_select
from .base import Model, domain_ids, model_generator


class _PPTowerBlock(nn.Module):
    """The ``D`` domain towers, stacked."""

    def __init__(self, input_dim: int, fcn_dims, domain_num: int, gen):
        super().__init__()
        self.dims = [input_dim] + list(fcn_dims)
        pairs = list(zip(self.dims[:-1], self.dims[1:]))
        self.mlps = nn.ModuleList([
            MLP(i, dims=[o], output_layer=False, members=domain_num, generator=gen)
            for i, o in pairs])
        self.gates = nn.ModuleList([
            GateNU(input_dim, o, members=domain_num, generator=gen) for _, o in pairs])
        self.final = Linear(self.dims[-1], 1, gen, lead=(domain_num,))

    def forward(self, gate_input, train: bool, w=None, generator=None):
        hidden = gate_input  # the JAX package's (and the reference's) quirk
        for i, (mlp, gate) in enumerate(zip(self.mlps, self.gates)):
            hidden = mlp(hidden, train, w, generator, per_member_x=i > 0) * gate(gate_input)
        return torch.sigmoid(self.final(hidden))  # [D, B, 1]


class PPNet(Model):
    def __init__(self, id_features, agn_features, domain_num: int, fcn_dims, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.id_features = tuple(id_features)
        self.agn_features = tuple(agn_features)
        self.domain_num = domain_num
        self.id_embedding = EmbeddingCollection(id_features, gen)
        self.agn_embedding = EmbeddingCollection(agn_features, gen)
        self.id_dims = sum_embed_dims(id_features)
        self.agn_dims = sum_embed_dims(agn_features)
        self.towers = _PPTowerBlock(self.id_dims + self.agn_dims, fcn_dims, domain_num, gen)

    def _gate_input(self, x):
        id_x = self.id_embedding(x, self.id_features, squeeze_dim=True)
        agn_x = self.agn_embedding(x, self.agn_features, squeeze_dim=True)
        return torch.cat([id_x, agn_x.detach()], dim=1)

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        ys = self.towers(self._gate_input(x), train, w, generator)
        return domain_select(ys, domain_ids(x))

    @torch.no_grad()
    def fold_eval(self):
        """``(layer_stages, gate_l1s, gate_l2s, final)``: each tower layer's
        BatchNorm folded into its Linear; valid until the weights or running
        stats change."""
        t = self.towers
        layers = []
        for mlp in t.mlps:
            stages, _ = fold_stacked_mlp_eval(mlp)
            assert len(stages) == 1, "PPNet's fused kernel takes one-layer tower stages"
            layers.append(stages[0])
        l1s = [(g.l1.w.detach(), g.l1.b.detach()) for g in t.gates]
        l2s = [(g.l2.w.detach(), g.l2.b.detach()) for g in t.gates]
        return layers, l1s, l2s, (t.final.w.detach(), t.final.b.detach())

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel, numerically equivalent to
        ``apply(train=False)``. ``w`` is accepted for the uniform trainer
        call: the eval math is per row, so the mask is unused."""
        for mlp in self.towers.mlps:
            assert mlp.act.name == "relu"
        if folded is None:
            folded = self.fold_eval()
        return ppnet_fused_infer(self._gate_input(x), domain_ids(x), *folded,
                                 gemma=self.towers.gates[0].gemma)
