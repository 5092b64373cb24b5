"""SAR-Net: per-domain scale/shift + shared/specific debias experts + gate.

The JAX package's ``models/sarnet.py``:

- each domain's elementwise scale (xavier-uniform, drawn as ``[1, in]``)
  and shift (U(0, 1)) of the embedding, ``dom_w``/``dom_b [D, in]``;
- a debias expert is BatchNorm1d -> Linear(in, 16). The ``n_shared``
  shared experts are one bank on the row's own domain's scaled embedding;
  the specific experts are one ``[D, n_spec]`` bank, row ``d`` reading
  domain ``d``'s scaled embedding of every row of the batch (so in train
  mode its BatchNorm statistics are taken over all of them), and each
  row's own domain is selected after;
- a softmax gate, Linear(in, n_shared + n_spec), on the selected scaled
  embedding; the gate-weighted expert mixture; MLP[32, 32] with its head;
  the sigmoid.

``apply_fused_eval`` runs everything after the embedding in one CUDA
kernel (``ops/kernels/sarnet_infer.py``), the debias experts folded.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import init as initializers
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_bn_linear_eval, fold_stacked_mlp_eval
from ..ops.kernels.sarnet_infer import sarnet_fused_infer
from ..ops.nn import MLP, BatchNorm, Linear
from .base import Model, domain_ids, model_generator


class _DebiasExpert(nn.Module):
    """BatchNorm(in) -> Linear(in, out), stacked on ``lead``."""

    def __init__(self, input_dim: int, gen, lead, out_dim: int = 16):
        super().__init__()
        self.bn = BatchNorm(input_dim, lead, device=gen.device)
        self.lin = Linear(input_dim, out_dim, gen, lead)

    def forward(self, x, train: bool, w=None):
        return self.lin(self.bn(x, train, w))


class Sarnet(Model):
    def __init__(self, features, domain_num: int, domain_shared_expert_num: int = 8,
                 domain_specific_expert_num: int = 2, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.features = tuple(features)
        self.input_dim = F = sum_embed_dims(features)
        self.domain_num = D = domain_num
        self.n_shared = domain_shared_expert_num
        self.n_spec = domain_specific_expert_num
        self.embedding = EmbeddingCollection(features, gen)
        xavier = initializers.xavier_uniform()
        self.dom_w = nn.Parameter(torch.cat([xavier(gen, (1, F)) for _ in range(D)]))
        self.dom_b = nn.Parameter(initializers.random_uniform(0.0, 1.0)(gen, (D, F)))
        self.shared = _DebiasExpert(F, gen, (self.n_shared,))
        self.spec = _DebiasExpert(F, gen, (D, self.n_spec))
        self.gate = Linear(F, self.n_shared + self.n_spec, gen)
        self.final = MLP(16, output_layer=True, dims=[32, 32], generator=gen)

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)  # [B, in]
        D = self.domain_num
        scaled = emb[None] * self.dom_w[:, None, :] + self.dom_b[:, None, :]  # [D, B, in]
        onehot = nn.functional.one_hot(torch.clamp(did.long(), 0, D - 1), D).to(emb.dtype)
        shared_emb = torch.einsum("bd,dbi->bi", onehot, scaled)
        shared_out = self.shared(shared_emb, train, w)                 # [n_shared, B, 16]
        spec_out = self.spec(scaled[:, None], train, w)                # [D, n_spec, B, 16]
        spec_sel = torch.einsum("bd,debo->ebo", onehot, spec_out)
        experts = torch.cat([shared_out, spec_sel])                    # [E, B, 16]
        gate = torch.softmax(self.gate(shared_emb), dim=-1)            # [B, E]
        mixed = torch.einsum("be,ebo->bo", gate, experts)
        return torch.sigmoid(self.final(mixed, train, w, generator))[:, 0]

    @torch.no_grad()
    def fold_eval(self):
        """``(dom_w, dom_b, shared, spec, gate, final_stages, final_out)``:
        each debias expert's BatchNorm folded into its Linear, the final
        MLP's into its stages; valid until the weights or running stats
        change."""
        final_stages, final_out = fold_stacked_mlp_eval(self.final)
        return (self.dom_w.detach(), self.dom_b.detach(),
                fold_bn_linear_eval(self.shared.bn, self.shared.lin),
                fold_bn_linear_eval(self.spec.bn, self.spec.lin),
                (self.gate.w.detach(), self.gate.b.detach()), final_stages, final_out)

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel, numerically equivalent to
        ``apply(train=False)``. ``w`` is accepted for the uniform trainer
        call: the eval math is per row, so the mask is unused."""
        assert self.final.act.name == "relu"
        if folded is None:
            folded = self.fold_eval()
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True)
        return sarnet_fused_infer(emb, did, *folded)
