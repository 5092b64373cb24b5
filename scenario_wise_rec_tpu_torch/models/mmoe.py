"""MMOE: shared experts + per-domain softmax gates + per-domain towers.

Experts and gates each are a stacked MLP bank (one ``[n, B, ·]`` batched
matmul per layer); the gate-weighted expert mixture is one einsum; towers +
select are a stacked tower bank + per-row gather. ``apply_fused_eval`` runs
everything after the embedding in one CUDA kernel
(``ops/kernels/mmoe_infer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core import config as compute_config
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_stacked_mlp_eval
from ..ops.kernels.mmoe_infer import mmoe_fused_infer
from ..ops.nn import MLP
from ..ops.select import domain_select
from .base import Model, domain_ids, model_generator


class MMOE(Model):
    def __init__(self, features, domain_num: int, n_expert: int,
                 expert_params: dict, tower_params: dict, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.features = tuple(features)
        self.domain_num = domain_num
        self.n_expert = n_expert
        self.input_dims = sum_embed_dims(features)
        self.embedding = EmbeddingCollection(features, gen)
        self.experts = MLP(self.input_dims, output_layer=False,
                           members=n_expert, generator=gen, **expert_params)
        # gate = MLP(input, dims=[n_expert], activation=softmax, no out layer)
        self.gates = MLP(self.input_dims, output_layer=False, dims=[n_expert],
                         activation="softmax", members=domain_num,
                         generator=gen)
        self.towers = MLP(expert_params["dims"][-1], members=domain_num,
                          generator=gen, **tower_params)

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)
        expert_outs = self.experts(emb, train, w, generator)  # [E, B, H]
        gate_outs = self.gates(emb, train, w, generator)  # [D, B, E] softmax over E
        # per-domain mixture: sum_e gate[d,b,e] * expert[e,b,h]
        mixed = compute_config.einsum("dbe,ebh->dbh", gate_outs, expert_outs)
        ys = self.towers(mixed, train, w, generator, per_member_x=True)  # [D, B, 1]
        return domain_select(torch.sigmoid(ys), did)

    def fold_eval(self):
        """The BatchNorm-folded affine stages ``apply_fused_eval`` runs on:
        ``(expert_stages, gate_stage, tower_stages, tower_out)``. Valid until
        the weights or running stats change; the trainer folds once per
        eval pass."""
        expert_stages, _ = fold_stacked_mlp_eval(self.experts)
        gate_stages, _ = fold_stacked_mlp_eval(self.gates)
        tower_stages, tower_out = fold_stacked_mlp_eval(self.towers)
        return expert_stages, gate_stages[0], tower_stages, tower_out

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused inference kernel.

        Numerically equivalent to ``apply(train=False)``. ``w`` is accepted
        for the uniform trainer call; the eval math here is per-row (no batch
        statistics), so the mask is unused. ``folded``: the result of
        :meth:`fold_eval` for the current weights (computed here if None).
        """
        assert self.experts.act.name == "relu" and self.towers.act.name == "relu"
        assert self.gates.act.name == "softmax"
        if folded is None:
            folded = self.fold_eval()
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True)
        return mmoe_fused_infer(emb, did, *folded)
