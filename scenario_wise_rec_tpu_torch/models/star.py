"""STAR: star topology FCN with shared (x) domain-specific weights.

The JAX package's ``models/star.py``:

- a domain norm over the **current batch's** statistics, at train and at
  eval time alike, with the padded (``w == 0``) rows masked out and eps
  1e-6; its gamma is ``share_gamma * gamma_d`` and its beta
  ``share_beta + beta_d``;
- an FCN whose layer weight for domain ``d`` is ``W_shared ⊙ W_d`` and
  bias ``b_shared + b_d``, one ``[D, in, out]`` product per layer;
- a per-domain BatchNorm1d and ReLU after every layer, the final width-1
  layer included;
- an auxiliary MLP whose logit is added before the sigmoid;
- kaiming-uniform weights with the torch fan quirk and U(0, 1) biases.

The module keeps the JAX tree's layout (``dn``, ``fcn.{share_w, share_b,
dom_w, dom_b}.<i>``, ``fcn.bn.<i>``, ``aux``) except for one entry: the JAX
package keeps the FCN BatchNorm's running stats at ``state.bn.<i>``, the
module beside its parameters at ``fcn.bn.<i>``; ``jax_state_map`` says so
to ``interop.load_jax_params``. ``apply_fused_eval`` runs everything after
the embedding and the domain norm's statistics in one CUDA kernel
(``ops/kernels/star_infer.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import config as compute_config
from ..core import init as initializers
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_stacked_mlp_eval
from ..ops.kernels.star_infer import star_fused_infer
from ..ops.nn import BN_EPS, MLP, BatchNorm, batch_stats
from ..ops.select import domain_select
from .base import Model, domain_ids, model_generator


class _FCN(nn.Module):
    def __init__(self, dims, num_domains, gen):
        super().__init__()
        kaiming = initializers.kaiming_uniform_torch()
        uniform01 = initializers.random_uniform(0.0, 1.0)
        pairs = list(zip(dims[:-1], dims[1:]))
        self.share_w = nn.ParameterList(
            [nn.Parameter(kaiming(gen, (i, o))) for i, o in pairs])
        self.share_b = nn.ParameterList(
            [nn.Parameter(uniform01(gen, (o,))) for _, o in pairs])
        # one draw per domain: the fan of a [D, in, out] draw would differ
        self.dom_w = nn.ParameterList(
            [nn.Parameter(torch.stack([kaiming(gen, (i, o)) for _ in range(num_domains)]))
             for i, o in pairs])
        self.dom_b = nn.ParameterList(
            [nn.Parameter(uniform01(gen, (num_domains, o))) for _, o in pairs])
        self.bn = nn.ModuleList(
            [BatchNorm(o, lead=(num_domains,), device=gen.device) for _, o in pairs])


class Star(Model):
    # the JAX tree's running stats of the FCN BatchNorms -> this module's keys
    jax_state_map = ((r"^bn\.(\d+)\.(mean|var)$", r"fcn.bn.\1.\2"),)

    def __init__(self, features, num_domains: int, fcn_dims, aux_dims,
                 device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.features = tuple(features)
        self.input_dim = sum_embed_dims(features)
        self.layer_num = len(fcn_dims) + 1
        self.fcn_dim = [self.input_dim] + list(fcn_dims) + [1]
        self.num_domains = num_domains
        self.eps = 1e-6
        self.embedding = EmbeddingCollection(features, gen)
        F, D, dev = self.input_dim, num_domains, gen.device
        self.dn = nn.ParameterDict({
            "share_gamma": nn.Parameter(torch.ones(F, device=dev)),
            "share_beta": nn.Parameter(torch.zeros(F, device=dev)),
            "gamma": nn.Parameter(torch.ones(D, F, device=dev)),
            "beta": nn.Parameter(torch.zeros(D, F, device=dev)),
        })
        self.fcn = _FCN(self.fcn_dim, D, gen)
        self.aux = MLP(self.input_dim, dims=list(aux_dims), generator=gen)

    def _domain_norm_affine(self):
        dn = self.dn
        return (dn["share_gamma"][None] * dn["gamma"],  # [D, in]
                dn["share_beta"][None] + dn["beta"])

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)
        aux_out = self.aux(emb, train, w, generator)  # [B, 1]
        mean, var, _ = batch_stats(emb, w)
        normed = (emb - mean) * torch.rsqrt(var + self.eps)  # [B, in]
        g, b = self._domain_norm_affine()
        h = g[:, None, :] * normed[None] + b[:, None, :]  # [D, B, in]
        fcn = self.fcn
        for i in range(self.layer_num):
            w_eff = fcn.share_w[i][None] * fcn.dom_w[i]  # [D, in, out]
            bias = fcn.share_b[i][None] + fcn.dom_b[i]   # [D, out]
            h = compute_config.einsum("dbi,dio->dbo", h, w_eff) + bias[:, None, :]
            h = torch.relu(fcn.bn[i](h, train, w))
        out = domain_select(h, did)  # [B]
        return torch.sigmoid(out + aux_out[:, 0])

    @torch.no_grad()
    def fold_eval(self):
        """``(dn_gamma, dn_beta, fcn_stages, aux_stages, aux_out)``: the
        domain norm's affine and every FCN layer's ``W_shared ⊙ W_d`` with
        its BatchNorm folded in (the JAX package's order of operations).
        The domain norm's statistics are not in it: they are the batch's."""
        dn_gamma, dn_beta = self._domain_norm_affine()
        fcn = self.fcn
        stages = []
        for i in range(self.layer_num):
            bn = fcn.bn[i]
            w_eff = fcn.share_w[i][None] * fcn.dom_w[i]
            b_eff = fcn.share_b[i][None] + fcn.dom_b[i]
            scale = bn.gamma * torch.rsqrt(bn.var + BN_EPS)  # [D, out]
            stages.append((w_eff * scale[:, None, :],
                           (b_eff - bn.mean) * scale + bn.beta))
        aux_stages, aux_out = fold_stacked_mlp_eval(self.aux)
        return dn_gamma, dn_beta, stages, aux_stages, aux_out

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel, numerically equivalent to
        ``apply(train=False)``: the domain norm's mean and rstd come from
        ``batch_stats(emb, w)`` outside the kernel, so the padded rows of a
        ragged batch (``w == 0``) do not move them."""
        assert self.aux.act.name == "relu" and self.aux.output_layer
        if folded is None:
            folded = self.fold_eval()
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True)
        mean, var, _ = batch_stats(emb, w)
        return star_fused_infer(emb, did, mean, torch.rsqrt(var + self.eps), *folded)
