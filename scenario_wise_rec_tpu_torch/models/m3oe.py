"""M3oE: a STAR-style fusion front end and a multi-expert balance stage.

The JAX package's ``models/m3oe.py``:

- the 3-layer STAR-style fusion: each domain's slot weight times the shared
  weight, ``W_d = slot_w[d] ⊙ shared_w``, on the embedding, the row's own
  domain selected, then an ``Mlp_N`` (Linear → LayerNorm → relu), plus a
  skip ``Mlp_N`` of the embedding;
- ``expert_num`` shared and ``domain_num`` domain experts, each an
  ``Mlp_N``; each domain's softmax gate reads a **detached** copy of the
  fused embedding;
- the learnable scalar mixing weights ``sigmoid(w_exp_d)`` and
  ``sigmoid(w_bal_d)`` (``w_exp_t``/``w_bal_t`` are created and never read:
  no gradient reaches them, and the trainer still steps them by weight
  decay, as optax does);
- the cross-domain balance mix ``(w − off)·dom_d + off·Σ dom`` with
  ``off = (1 − w)/(D − 1)`` (``w·dom_d`` when ``D == 1``) and the expert
  fusion ``gate·experts + w_exp·balanced``;
- per-domain towers (Linear → LayerNorm → relu → Linear), sigmoid, and each
  row's own domain selected.

The parameters keep the JAX tree's names and nesting, lists of lists
included, so that ``interop`` copies them by path. It has no state: every
norm is a LayerNorm of the row's own values, so the padding mask is unused.

``apply_fused_eval`` runs everything after the embedding in one CUDA
kernel (``ops/kernels/m3oe_infer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import config as compute_config
from ..core import init as initializers
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.m3oe_infer import m3oe_fused_infer
from ..ops.nn import LayerNorm, Linear
from ..ops.select import domain_select
from .base import Model, domain_ids, model_generator


class _LnLayer(nn.Module):
    """Linear → LayerNorm → relu."""

    def __init__(self, in_dim, out_dim, gen):
        super().__init__()
        self.lin = Linear(in_dim, out_dim, gen)
        self.ln = LayerNorm(out_dim, device=gen.device)

    def forward(self, x):
        return torch.relu(self.ln(self.lin(x)))


class MlpN(nn.Sequential):
    """The reference's ``Mlp_N``: a Linear → LayerNorm → relu layer per
    pair of neighbouring widths in ``dims``."""

    def __init__(self, dims, gen):
        super().__init__(*[_LnLayer(i, o, gen) for i, o in zip(dims[:-1], dims[1:])])


class _Tower(nn.Module):
    def __init__(self, h, gen):
        super().__init__()
        self.l1 = Linear(h, h, gen)
        self.ln = LayerNorm(h, device=gen.device)
        self.l2 = Linear(h, 1, gen)

    def forward(self, x):
        return self.l2(torch.relu(self.ln(self.l1(x))))


class M3oE(Model):
    def __init__(self, features, domain_num: int, fcn_dims, expert_num: int, exp_d, exp_t,
                 bal_d, bal_t, tau: float = 1.0, task_num: int = 1, tau_step: float = 0.00005,
                 softmax_type: int = 3, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if softmax_type != 3:
            raise ValueError("only softmax_type=3 is reachable in the reference")
        gen = model_generator(device, generator)
        dev = gen.device
        self.features = tuple(features)
        self.input_dim = sum_embed_dims(features)
        fcn = [self.input_dim] + list(fcn_dims)
        if len(fcn) <= 3:
            raise ValueError("too few layers assigned, must larger than 3. Star owns 3 "
                             "layers, mmoe owns the rest.")
        self.star_dim, self.fcn_dim = fcn[:3], fcn[3:]
        self.domain_num = D = domain_num
        self.task_num = task_num
        self.expert_num = expert_num
        self.embedding = EmbeddingCollection(features, gen)
        scalar = lambda v: nn.Parameter(torch.full((1,), float(v), device=dev))
        self.w_exp_d, self.w_exp_t = scalar(exp_d), scalar(exp_t)
        self.w_bal_d, self.w_bal_t = scalar(bal_d), scalar(bal_t)
        s0, s1, s2 = self.star_dim
        xavier = initializers.xavier_uniform()
        self.skip = MlpN([s0, s2], gen)
        self.shared_w = nn.Parameter(xavier(gen, (s0, s1)))
        self.shared_b = nn.Parameter(torch.zeros(s1, device=dev))
        self.slot_w = nn.Parameter(torch.stack([xavier(gen, (s0, s1)) for _ in range(D)]))
        self.slot_b = nn.Parameter(torch.zeros(D, s1, device=dev))
        self.star_mlp = MlpN([s1, s2], gen)
        self.experts = nn.ModuleList([MlpN(self.fcn_dim, gen) for _ in range(expert_num)])
        self.domain_experts = nn.ModuleList([MlpN(self.fcn_dim, gen) for _ in range(D)])
        self.gates = nn.ModuleList([Linear(self.fcn_dim[0], expert_num, gen)
                                    for _ in range(D)])
        self.towers = nn.ModuleList([_Tower(self.fcn_dim[-1], gen) for _ in range(D)])

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        did = domain_ids(x)
        D = self.domain_num
        input_emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)

        # STAR fusion front end: the row's own domain's slot (a gather; the
        # JAX package contracts a one-hot, which is exact and has the same
        # gradient)
        skip = self.skip(input_emb)
        w_slot = self.slot_w * self.shared_w[None]  # [D, s0, s1]
        star = (compute_config.einsum("bi,dio->dbo", input_emb, w_slot)
                + self.slot_b[:, None, :] + self.shared_b[None, None, :])
        own = torch.clamp(did.long(), 0, D - 1)
        emb = star[own, torch.arange(star.shape[1], device=star.device)]
        emb = self.star_mlp(emb) + skip  # [B, s2]

        # the gates read a detached copy
        emb_sg = emb.detach()
        gate_value = torch.stack([torch.softmax(g(emb_sg), dim=1) for g in self.gates])
        fea = torch.stack([m(emb) for m in self.experts], dim=1)            # [B, E, h]
        domain_fea = torch.stack([m(emb) for m in self.domain_experts], dim=1)  # [B, D, h]

        # the cross-domain balance mix
        w_bal = torch.sigmoid(self.w_bal_d)[0]
        if D > 1:
            off = (1 - w_bal) / (D - 1)
            weighted = ((w_bal - off) * domain_fea
                        + off * torch.sum(domain_fea, dim=1)[:, None, :])
        else:
            weighted = w_bal * domain_fea
        w_exp = torch.sigmoid(self.w_exp_d)[0]
        fused = (torch.einsum("dbe,beh->dbh", gate_value, fea)
                 + w_exp * weighted.transpose(0, 1))  # [D, B, h]
        ys = torch.stack([torch.sigmoid(t(fused[d]))[:, 0] for d, t in enumerate(self.towers)])
        return domain_select(ys, did)

    @torch.no_grad()
    def fold_eval(self):
        """``m3oe_fused_infer``'s weights after its two inputs: the star
        slots ``(slot_w ⊙ shared_w, slot_b + shared_b)``, the skip and star
        MLP layers, the stacked gates, the expert and domain expert layers
        stacked on their member axis, the stacked towers and the two
        sigmoids; valid until the weights change."""
        def plain(layers):
            return [(l.lin.w.detach(), l.lin.b.detach(), l.ln.gamma.detach(),
                     l.ln.beta.detach()) for l in layers]

        def stacked(members):
            return [tuple(torch.stack(t) for t in zip(*layer))
                    for layer in zip(*[plain(m) for m in members])]

        star = (self.slot_w * self.shared_w[None], self.slot_b + self.shared_b[None])
        gates = (torch.stack([g.w for g in self.gates]), torch.stack([g.b for g in self.gates]))
        towers = tuple(torch.stack([getattr(getattr(t, m), n) for t in self.towers])
                       for m, n in (("l1", "w"), ("l1", "b"), ("ln", "gamma"), ("ln", "beta"),
                                    ("l2", "w"), ("l2", "b")))
        return (star, plain(self.skip), plain(self.star_mlp), gates, stacked(self.experts),
                stacked(self.domain_experts), towers, torch.sigmoid(self.w_exp_d),
                torch.sigmoid(self.w_bal_d))

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel, numerically equal to
        ``apply(train=False)``. ``w`` is accepted for the uniform trainer
        call: the eval math is per row, so the mask is unused."""
        if folded is None:
            folded = self.fold_eval()
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True)
        return m3oe_fused_infer(emb, did, *folded)
