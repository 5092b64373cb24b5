"""M2M: meta-attention and a meta-tower over transformer-mixed features.

The JAX package's ``models/m2m.py``:

- the flat embedding goes through a full :class:`~..ops.transformer.
  Transformer` called as ``transformer(emb, emb)`` on a 2-D tensor, torch's
  unbatched length-B sequence: attention ACROSS the examples of a batch,
  padded rows masked out as keys;
- 4 leakyrelu expert MLPs on the transformer output, one stacked bank;
- meta-attention: each row's attention matrix ``[2E, 2E]`` and bias are
  *generated* from the scenario embedding by hyper-MLPs (``vw``, ``vb``)
  and score each expert's ``[expert ‖ task]``, softmax over the experts;
- meta-tower: a generated ``[E, E]`` matrix (``tw``) and bias (``tb``) and
  the residual, leakyrelu;
- the output MLP [64, 32] and its head, sigmoid. No domain select: the
  scenario enters through the scenario embedding alone.

The domain feature is in both ``features`` and ``domain_feature``: with the
trainer's pre-gathered ``rows`` both lookups slice the same segment, so the
two gradients add up in one table row.

``apply_fused_eval`` runs the transformer in PyTorch (it is batch-global)
and everything after it in one CUDA kernel (``ops/kernels/m2m_infer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.activations import leaky_relu
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_stacked_mlp_eval
from ..ops.kernels.m2m_infer import m2m_fused_infer
from ..ops.nn import MLP
from ..ops.transformer import Transformer
from .base import Model, model_generator

HYPER = ("task", "scenario", "vw", "vb", "tw", "tb")


class M2M(Model):
    def __init__(self, features, domain_feature, domain_num: int, num_experts: int = 4,
                 expert_output_size: int = 16, transformer_dims: Optional[dict] = None,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        if transformer_dims is None:
            transformer_dims = {"num_encoder_layers": 2, "num_decoder_layers": 2,
                                "dim_feedforward": 16}
        self.features = tuple(features)
        self.domain_feature = tuple(domain_feature)
        self.embedding = EmbeddingCollection(features, gen)
        self.input_dim = sum_embed_dims(features)
        self.num_experts = num_experts
        self.E = E = expert_output_size
        self.domain_num = domain_num
        self.transformer = Transformer(self.input_dim, nhead=4, generator=gen,
                                       **transformer_dims)
        dd = self.domain_feature[0].embed_dim
        self.v = nn.Parameter(torch.ones((2 * E, 1), device=gen.device))
        lrelu = dict(output_layer=False, activation="leakyrelu", generator=gen)
        self.experts = MLP(self.input_dim, dims=[E], members=num_experts, **lrelu)
        widths = {"task": (dd, E), "scenario": (dd, E), "vw": (E, 4 * E * E),
                  "vb": (E, 2 * E), "tw": (E, E * E), "tb": (E, E)}
        for name in HYPER:
            i, o = widths[name]
            setattr(self, name, MLP(i, dims=[o], **lrelu))
        self.out = MLP(E, dims=[64, 32], generator=gen)

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        E, nE = self.E, self.num_experts
        dom_emb = self.embedding(x, self.domain_feature, squeeze_dim=True, rows=rows)
        emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)  # [B, in]
        B = emb.shape[0]
        t_out = self.transformer(emb, emb, train, generator, w)  # [B, in], cross-row
        scen = self.scenario(dom_emb, train, w, generator)
        task = self.task(dom_emb, train, w, generator)
        experts = self.experts(t_out, train, w, generator).transpose(0, 1)  # [B, nE, E]

        # meta-attention
        meta_in = torch.cat([experts, task[:, None, :].expand(B, nE, E)], dim=2)
        meta_w = self.vw(scen, train, w, generator).reshape(B, 2 * E, 2 * E)
        vb = self.vb(scen, train, w, generator)
        meta = leaky_relu(torch.einsum("bne,bef->bnf", meta_in, meta_w) + vb[:, None, :])
        alpha = torch.softmax(torch.einsum("bnf,fo->bno", meta, self.v)[..., 0], dim=1)
        rt = torch.einsum("bn,bne->be", alpha, experts)  # [B, E]

        # meta-tower
        tower_w = self.tw(scen, train, w, generator).reshape(B, E, E)
        tb = self.tb(scen, train, w, generator)
        h = leaky_relu(torch.einsum("be,bef->bf", rt, tower_w) + tb + rt)
        return torch.sigmoid(self.out(h, train, w, generator))[:, 0]

    def fold_eval(self):
        """``m2m_fused_infer``'s weights after its two inputs, every
        BatchNorm folded: ``(expert_stages, task, scenario, vw, vb, tw, tb,
        v, out_stages, out_head)``; valid until the weights or running stats
        change."""
        hyper = [fold_stacked_mlp_eval(getattr(self, n))[0] for n in HYPER]
        out_stages, out_head = fold_stacked_mlp_eval(self.out)
        return (fold_stacked_mlp_eval(self.experts)[0], *hyper, self.v.detach(),
                out_stages, out_head)

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward: the transformer in PyTorch with ``w`` as its key
        mask, then the fused kernel; equal to ``apply(train=False)`` up to
        the order of the generated-weight sums."""
        assert self.out.act.name == "relu" and self.out.output_layer
        for name in ("experts",) + HYPER:
            assert getattr(self, name).act.name == "leakyrelu"
        if folded is None:
            folded = self.fold_eval()
        dom_emb = self.embedding(x, self.domain_feature, squeeze_dim=True)
        emb = self.embedding(x, self.features, squeeze_dim=True)
        t_out = self.transformer(emb, emb, train=False, w=w)
        return m2m_fused_infer(t_out, dom_emb, *folded, E=self.E)
