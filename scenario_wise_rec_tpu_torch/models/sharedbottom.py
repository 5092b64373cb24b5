"""SharedBottom: shared bottom MLP -> per-domain tower MLPs.

The JAX package's ``models/sharedbottom.py``: one shared relu trunk on the
embedding, then ``D`` towers as one stacked ``[D, B, 1]`` bank, sigmoid and
a per-row gather of each row's own domain. ``apply_fused_eval`` runs
everything after the embedding in one CUDA kernel
(``ops/kernels/tower_infer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_stacked_mlp_eval
from ..ops.kernels.tower_infer import trunk_towers_fused_infer
from ..ops.nn import MLP
from ..ops.select import domain_select
from .base import Model, domain_ids, model_generator


class SharedBottom(Model):
    def __init__(self, features, domain_num: int, bottom_params: dict,
                 tower_params: dict, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.features = tuple(features)
        self.domain_num = domain_num
        self.embedding = EmbeddingCollection(features, gen)
        self.bottom_dims = sum_embed_dims(features)
        self.bottom = MLP(self.bottom_dims, generator=gen,
                          **{**bottom_params, "output_layer": False})
        self.towers = MLP(bottom_params["dims"][-1], members=domain_num,
                          generator=gen, **tower_params)

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)
        h = self.bottom(emb, train, w, generator)
        ys = self.towers(h, train, w, generator)  # [D, B, 1]
        return domain_select(torch.sigmoid(ys), did)

    def fold_eval(self):
        """``(trunk_stages, tower_stages, tower_out)``, BatchNorm folded;
        valid until the weights or running stats change."""
        trunk, _ = fold_stacked_mlp_eval(self.bottom)
        towers, tower_out = fold_stacked_mlp_eval(self.towers)
        return trunk, towers, tower_out

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel, numerically equivalent to
        ``apply(train=False)``. ``w`` is accepted for the uniform trainer
        call: the eval math is per row, so the mask is unused."""
        assert self.bottom.act.name == "relu" and self.towers.act.name == "relu"
        if folded is None:
            folded = self.fold_eval()
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True)
        return trunk_towers_fused_infer(emb, did, *folded)
