"""HAMUR: per-domain MLP backbones with adapters generated by a shared
hyper-network, and the plain per-domain MLP baseline ``MlpNLayer``.

The JAX package's ``models/hamur.py``:

- per-domain blocks ``[Linear -> BatchNorm -> ReLU]``, a ``[D, in, out]``
  bank with per-domain masked BatchNorm, then a per-domain ``Linear(·, 1)``,
  the sigmoid, and each row's own domain selected;
- a *shared* hyper-network ``[Linear -> BatchNorm -> ReLU]*`` maps the
  embedding to ``H [B, k, k]``. The reference runs it once per domain branch
  on the same input: the same outputs, but its BatchNorm running stats take
  D updates per forward. It runs once here, and its running stats take the
  D updates in one EMA step of momentum ``1 - (1 - 0.1)^D``;
- adapter cells after the given blocks: ``((h U_down) H_b) V_down`` →
  sigmoid → ``((t U_up) H_b) V_up``, then a norm by the **current batch's**
  masked statistics (unbiased variance, eps 1e-5, gamma/beta shared by the
  domains), at eval time too, and the residual. HamurLarge has adapters
  after blocks 6 and 7, HamurSmall after block 2. ``u_*``/``v_*`` start at
  ones, the biases at zero.

The module keeps the JAX tree's paths: ``blocks.<i>.{lin,bn}``,
``final``, ``hyper.<i>.{lin,bn}``, ``adapters.<j>.<name>``; the JAX tree
keeps the BatchNorms' running stats at ``state.{blocks,hyper}.<i>``, the
module beside their parameters (``jax_state_map``).

``apply_fused_eval`` runs the segments through the CUDA kernel
(``ops/kernels/hamur_infer.py``): 3 launches a batch for HamurLarge, 2 for
HamurSmall.

``MlpNLayer`` is the JAX package's ``_Hamur`` with no adapters (its
hyper-network is built, trained by weight decay only, and never run). Its
``state_dict`` keys are that tree's, so it holds its embedding collection
under ``embedding`` like the others; but the JAX trainer gives it the plain
dense step because the JAX class has no ``embedding`` attribute, and it has
no fused eval. So the port's class reads ``model.embedding`` as None (a
class property that hides the registered submodule from attribute lookup),
and the trainer, which asks ``getattr(model, "embedding", None)`` and
``hasattr(model, "apply_fused_eval")``, takes the dense step and serves it
op by op with no branch of its own.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core import config as compute_config
from ..core.activations import activation as activation_factory
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.kernels.folding import fold_layers_eval
from ..ops.kernels.hamur_infer import hamur_fused_infer
from ..ops.nn import BN_MOMENTUM, Linear, _Layer, domain_norm
from ..ops.select import domain_select
from .base import Model, domain_ids, model_generator

ADAPTER_MID = 32   # the adapters' down-projection width
ADAPTER_EPS = 1e-5


class _HamurNet(Model):
    """The op-by-op HAMUR network; ``adapter_after``: 1-indexed blocks."""

    # the JAX tree's running stats -> this module's keys
    jax_state_map = ((r"^blocks\.(\d+)\.(mean|var)$", r"blocks.\1.bn.\2"),
                     (r"^hyper\.(\d+)\.(mean|var)$", r"hyper.\1.bn.\2"))

    def __init__(self, features, domain_num: int, fcn_dims, hyper_dims, k: int,
                 adapter_after, device="cuda", generator: Optional[torch.Generator] = None):
        super().__init__()
        gen = model_generator(device, generator)
        self.features = tuple(features)
        self.input_dim = sum_embed_dims(features)
        self.fcn_dim = [self.input_dim] + list(fcn_dims)
        self.domain_num = D = int(domain_num)
        self.k = int(k)
        self.adapter_after = tuple(adapter_after)
        self.hyper_dims = list(hyper_dims) + [self.k * self.k]
        relu = activation_factory("relu")
        self.embedding = EmbeddingCollection(features, gen)
        self.blocks = nn.ModuleList(
            [_Layer(i, o, relu, gen, (D,)) for i, o in zip(self.fcn_dim[:-1], self.fcn_dim[1:])])
        self.final = Linear(self.fcn_dim[-1], 1, gen, (D,))
        dims = [self.input_dim] + self.hyper_dims
        self.hyper = nn.ModuleList([_Layer(i, o, relu, gen, ()) for i, o in zip(dims[:-1],
                                                                                 dims[1:])])
        dev = gen.device
        self.adapters = nn.ModuleList()
        for blk in self.adapter_after:
            w, m = self.fcn_dim[blk], ADAPTER_MID
            self.adapters.append(nn.ParameterDict({
                "u_down": nn.Parameter(torch.ones(w, self.k, device=dev)),
                "v_down": nn.Parameter(torch.ones(self.k, m, device=dev)),
                "b_down": nn.Parameter(torch.zeros(m, device=dev)),
                "u_up": nn.Parameter(torch.ones(m, self.k, device=dev)),
                "v_up": nn.Parameter(torch.ones(self.k, w, device=dev)),
                "b_up": nn.Parameter(torch.zeros(w, device=dev)),
                "gamma": nn.Parameter(torch.ones(w, device=dev)),
                "beta": nn.Parameter(torch.zeros(w, device=dev)),
            }))

    def _embed(self, x, rows=None):
        # the registered collection (MlpNLayer hides the attribute)
        return self._modules["embedding"](x, self.features, squeeze_dim=True, rows=rows)

    def _hyper_apply(self, emb, train: bool, w=None):
        """``H [B, k, k]``; a train-mode call advances each BatchNorm's
        running stats as D identical updates would."""
        momentum = 1.0 - (1.0 - BN_MOMENTUM) ** self.domain_num
        h = emb
        for layer in self.hyper:
            h = torch.relu(layer.bn(layer.lin(h), train, w, momentum=momentum))
        return h.reshape(-1, self.k, self.k)

    @staticmethod
    def _adapter(a, h, hyper, w=None):
        """One adapter cell on every domain's ``h [D, B, F]``, re-associated
        ``((h U) H_b) V`` as the kernel computes it."""
        mm, ein = compute_config.matmul, compute_config.einsum
        q = ein("dbi,bij->dbj", mm(h, a["u_down"]), hyper)
        t = torch.sigmoid(mm(q, a["v_down"]) + a["b_down"])
        q = ein("dbi,bij->dbj", mm(t, a["u_up"]), hyper)
        t = mm(q, a["v_up"]) + a["b_up"]
        return domain_norm(t, a["gamma"], a["beta"], eps=ADAPTER_EPS, unbiased=True,
                           w=w) + h

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        did = domain_ids(x)
        emb = self._embed(x, rows)
        hyper = self._hyper_apply(emb, train, w) if self.adapter_after else None
        adapters = {blk: j for j, blk in enumerate(self.adapter_after)}
        h = emb  # [B, in], shared by every domain's first block -> [D, B, out]
        for i, blk in enumerate(self.blocks):
            h = torch.relu(blk.bn(blk.lin(h), train, w))
            if i + 1 in adapters:
                h = self._adapter(self.adapters[adapters[i + 1]], h, hyper, w)
        return domain_select(torch.sigmoid(self.final(h)), did)


class _Hamur(_HamurNet):
    @torch.no_grad()
    def fold_eval(self):
        """``(hyper_stages, segments, adapters, final)``: every BatchNorm
        folded into its Linear, the blocks cut after each adapter. The
        adapters' norm statistics are not in it: they are each batch's."""
        blocks = fold_layers_eval(self.blocks)
        segments, seg = [], []
        for i, stage in enumerate(blocks):
            seg.append(stage)
            if i + 1 in self.adapter_after:
                segments.append(seg)
                seg = []
        segments.append(seg)
        adapters = [{n: t.detach() for n, t in a.items()} for a in self.adapters]
        return (fold_layers_eval(self.hyper), segments, adapters,
                (self.final.w.detach(), self.final.b.detach()))

    def apply_fused_eval(self, x, w=None, folded=None):
        """Eval forward through the segment kernel, equal to
        ``apply(train=False)`` up to float reassociation (amplified by the
        adapter norms' ``rsqrt(var)``): the norms' statistics are taken over
        each segment's output between the launches, the padded rows of a
        ragged batch (``w == 0``) masked out."""
        if folded is None:
            folded = self.fold_eval()
        hyper, segments, adapters, final = folded
        return hamur_fused_infer(self._embed(x), domain_ids(x), hyper, self.k, segments,
                                 adapters, final, eps=ADAPTER_EPS, w=w)


class HamurLarge(_Hamur):
    """7 blocks, adapters after blocks 6 and 7."""

    def __init__(self, features, domain_num, fcn_dims, hyper_dims, k, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if len(fcn_dims) != 7:
            raise ValueError("HamurLarge expects 7 fcn dims")
        super().__init__(features, domain_num, fcn_dims, hyper_dims, k, (6, 7), device,
                         generator)


class HamurSmall(_Hamur):
    """2 blocks, one adapter after block 2."""

    def __init__(self, features, domain_num, fcn_dims, hyper_dims, k, device="cuda",
                 generator: Optional[torch.Generator] = None):
        if len(fcn_dims) != 2:
            raise ValueError("HamurSmall expects 2 fcn dims")
        super().__init__(features, domain_num, fcn_dims, hyper_dims, k, (2,), device,
                         generator)


class MlpNLayer(_HamurNet):
    """Per-domain plain MLPs (the reference's ``Mlp_2_Layer``/``Mlp_7_Layer``):
    HAMUR with no adapters, ``hyper_dims=[8]`` and ``k=2``. No fused eval;
    the trainer takes the plain dense step (see the module docstring)."""

    # hides the registered collection from attribute lookup; state_dict,
    # parameters() and .to() still see it
    embedding = property(lambda self: None)

    def __init__(self, features, domain_num, fcn_dims, device="cuda",
                 generator: Optional[torch.Generator] = None):
        super().__init__(features, domain_num, fcn_dims, hyper_dims=[8], k=2,
                         adapter_after=(), device=device, generator=generator)
