"""PLE: stacked CGC levels with domain-specific and shared experts.

The JAX package's ``models/ple.py``. Each level reads ``D + 1`` input
streams (one per domain, one shared; all the embedding at level 1):

- the specific experts are one doubly stacked ``[D, S]`` bank, row ``d``
  reading stream ``d``; the shared experts an ``[n_shared]`` bank on the
  shared stream;
- each domain's softmax gate mixes its own ``S`` specifics and the shared
  experts into its next stream;
- a level before the last also has a shared softmax gate over all
  ``D·S + n_shared`` experts, which makes the next shared stream;
- the towers read the ``D`` domain streams of the last level.

``apply_fused_eval`` runs everything after the embedding in one CUDA
kernel (``ops/kernels/ple_infer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_stacked_mlp_eval
from ..ops.kernels.ple_infer import LevelSpec, ple_fused_infer
from ..ops.nn import MLP
from ..ops.select import domain_select
from .base import Model, domain_ids, model_generator


class PLE(Model):
    def __init__(self, features, domain_num: int, n_level: int,
                 n_expert_specific: int, n_expert_shared: int,
                 expert_params: dict, tower_params: dict, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.features = tuple(features)
        self.domain_num = domain_num
        self.n_level = n_level
        self.n_spec = n_expert_specific
        self.n_shared = n_expert_shared
        self.input_dims = sum_embed_dims(features)
        self.embedding = EmbeddingCollection(features, gen)
        D, S = domain_num, n_expert_specific
        h = expert_params["dims"][-1]
        n_all = S * D + n_expert_shared
        levels = []
        for lvl in range(n_level):
            in_dim = self.input_dims if lvl == 0 else h
            level = nn.ModuleDict({
                "spec": MLP(in_dim, output_layer=False, members=(D, S),
                            generator=gen, **expert_params),
                "shared": MLP(in_dim, output_layer=False, members=n_expert_shared,
                              generator=gen, **expert_params),
                "gates": MLP(in_dim, output_layer=False, dims=[S + n_expert_shared],
                             activation="softmax", members=D, generator=gen),
            })
            if lvl < n_level - 1:
                level["gate_shared"] = MLP(in_dim, output_layer=False, dims=[n_all],
                                           activation="softmax", generator=gen)
            levels.append(level)
        self.levels = nn.ModuleList(levels)
        self.towers = MLP(h, output_layer=True, members=D, generator=gen,
                          **tower_params)

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)
        D = self.domain_num
        streams = emb.expand((D,) + tuple(emb.shape))  # [D, B, in]
        shared_in = emb
        for level in self.levels:
            spec = level["spec"](streams, train, w, generator,
                                 per_member_x=True)              # [D, S, B, H]
            shared = level["shared"](shared_in, train, w, generator)  # [n_sh, B, H]
            gates = level["gates"](streams, train, w, generator,
                                   per_member_x=True)            # [D, B, S + n_sh]
            experts = torch.cat(
                [spec, shared[None].expand((D,) + tuple(shared.shape))], dim=1)
            mixed = torch.einsum("dbe,debh->dbh", gates, experts)
            if "gate_shared" in level:
                gs = level["gate_shared"](shared_in, train, w, generator)  # [B, n_all]
                every = torch.cat([spec.reshape((-1,) + tuple(spec.shape[2:])), shared])
                shared_in = torch.einsum("be,ebh->bh", gs, every)
            streams = mixed
        ys = self.towers(streams, train, w, generator, per_member_x=True)  # [D, B, 1]
        return domain_select(torch.sigmoid(ys), did)

    def fold_eval(self):
        """``(levels, tower_stages, tower_out)`` with ``levels`` a list of
        :class:`LevelSpec`, BatchNorm folded; valid until the weights or
        running stats change."""
        specs = []
        for level in self.levels:
            gs = (fold_stacked_mlp_eval(level["gate_shared"])[0]
                  if "gate_shared" in level else None)
            specs.append(LevelSpec(fold_stacked_mlp_eval(level["spec"])[0],
                                   fold_stacked_mlp_eval(level["shared"])[0],
                                   fold_stacked_mlp_eval(level["gates"])[0], gs))
        towers, tower_out = fold_stacked_mlp_eval(self.towers)
        return specs, towers, tower_out

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel, numerically equivalent to
        ``apply(train=False)``. ``w`` is accepted for the uniform trainer
        call: the eval math is per row, so the mask is unused."""
        assert self.towers.act.name == "relu"
        for level in self.levels:
            assert level["spec"].act.name == "relu" and level["gates"].act.name == "softmax"
        if folded is None:
            folded = self.fold_eval()
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True)
        return ple_fused_infer(emb, did, *folded)
