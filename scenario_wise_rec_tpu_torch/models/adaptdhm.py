"""AdaptDHM: rows routed to clusters by EMA centers, each cluster's FCN
the shared weights times its own.

The JAX package's ``models/adaptdhm.py``:

- L2-normalised cluster centers are carried state, the ``center`` buffer.
  A train-mode forward refines them 3 times (``beta * center + (1 - beta)
  * softmax-weighted sum of the rows``, renormalised by ``max(|v|,
  1e-12)``), the padded (``w == 0``) rows masked out, routes by the refined
  centers and stores them; under ``no_grad`` on the detached embedding. An
  eval forward routes by the stored centers and moves nothing;
- each row's cluster is the argmax of its soft assignment;
- the FCN's stage for cluster ``c`` is ``W_0 ⊙ W_{c+1}``, ``[C, in, out]``
  stacked, relu after every stage but the last, sigmoid after it. The
  biases ``b.<branch>.<layer>`` are created (N(0, 1e-7)) and never applied,
  as in the reference: they have no gradient, and only weight decay moves
  them (the trainer steps every dense parameter);
- every cluster runs densely on the batch and the routed output is taken.

``apply_fused_eval`` routes by ``argmax(emb @ center.T)`` (the softmax is
monotone) and runs the routed FCN in one CUDA kernel
(``ops/kernels/adaptdhm_infer.py``): SharedBottom's chain kernel,
``csrc/tower_infer.cu``, without a trunk and without biases, one cluster a
block, every product on the tensor cores.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core import config as compute_config
from ..core import init as initializers
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.adaptdhm_infer import adaptdhm_fused_infer
from .base import Model, model_generator


def l2norm(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """torch ``F.normalize(p=2)`` over the last axis: ``v / max(|v|, eps)``."""
    n = torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))
    return v / torch.clamp(n, min=eps)


class AdaptDHM(Model):
    def __init__(self, features, fcn_dims, cluster_num: int, beta: float, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.features = tuple(features)
        self.beta = float(beta)
        self.cluster_num = C = int(cluster_num)
        self.layer_num = len(fcn_dims) + 1
        self.dims = sum_embed_dims(features)
        self.fcn_dims = [self.dims] + list(fcn_dims) + [1]
        self.embedding = EmbeddingCollection(features, gen)
        xavier = initializers.xavier_uniform(gain=math.sqrt(2.0))  # relu gain
        bias_init = initializers.random_normal(0.0, 1e-7)
        pairs = list(zip(self.fcn_dims[:-1], self.fcn_dims[1:]))
        # branch 0: the shared FCN; branches 1..C: one per cluster
        self.w = nn.ModuleList([nn.ParameterList([nn.Parameter(xavier(gen, (i, o)))
                                                  for i, o in pairs]) for _ in range(C + 1)])
        self.b = nn.ModuleList([nn.ParameterList([nn.Parameter(bias_init(gen, (o,)))
                                                  for _, o in pairs]) for _ in range(C + 1)])
        self.register_buffer("center", l2norm(initializers.random_normal()(gen, (C, self.dims))))

    @torch.no_grad()
    def _route(self, emb, train: bool, w=None):
        """Each row's cluster; a train-mode call refines and stores the
        centers first."""
        x = emb.detach()
        center = self.center
        if train:
            wc = None if w is None else w.reshape(-1, 1).to(x.dtype)
            for _ in range(3):
                rij = torch.softmax(x @ center.T, dim=1)
                if wc is not None:
                    rij = rij * wc
                center = l2norm(self.beta * center + (1 - self.beta) * (rij.T @ x))
            self.center.copy_(center)
        return torch.argmax(torch.softmax(x @ center.T, dim=1), dim=1)

    def _stages(self):
        """Each layer's ``[C, in, out]`` weights ``W_0 ⊙ W_{c+1}``."""
        w0 = self.w[0]
        return [torch.stack([w0[i] * self.w[c + 1][i] for c in range(self.cluster_num)])
                for i in range(self.layer_num)]

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)
        router = self._route(emb, train, w)
        stages = self._stages()
        h = emb  # [B, in], shared by every cluster -> [C, B, out]
        for st in stages[:-1]:
            h = torch.relu(compute_config.matmul(h, st))
        h = torch.sigmoid(compute_config.matmul(h, stages[-1]))[..., 0]  # [C, B]
        return torch.gather(h.t(), 1, router[:, None])[:, 0]

    @torch.no_grad()
    def fold_eval(self):
        """The stacked ``[C, in, out]`` stages, valid until the weights change."""
        return self._stages()

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the fused kernel, equal to
        ``apply(train=False)`` except where rounding ties the softmax. ``w``
        is accepted for the uniform trainer call: the eval math is per row,
        so the mask is unused."""
        if folded is None:
            folded = self.fold_eval()
        emb = self.embedding(x, self.features, squeeze_dim=True)
        router = torch.argmax(emb @ self.center.T, dim=1)
        return adaptdhm_fused_infer(emb, router, folded)
