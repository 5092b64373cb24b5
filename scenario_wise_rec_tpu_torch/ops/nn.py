"""NN building blocks as ``nn.Module``s with optional stacked members.

The counterpart of the JAX package's ``ops/nn.py``:

- ``linear``          — y = x @ W + b, W stored (in, out)
- ``batchnorm``       — torch BatchNorm1d semantics (batch stats in train,
                        running stats in eval, unbiased-var running update),
                        with the weight-masked ``batch_stats`` so padded rows
                        stay invisible
- ``layernorm``       — torch LayerNorm over the last axis (biased variance,
                        eps 1e-5), with a ``LayerNorm`` module for its
                        ``gamma``/``beta``
- ``MLP``             — [Linear -> BN -> act -> Dropout]* (+ optional (·,1) head)
- ``GateNU``          — PEPNet's gate ``gemma·sigmoid(relu(x W1 + b1) W2 + b2)``
- ``Pruner``          — AdaSparse's bias-free pruner on ``[sce ‖ h]``
- ``domain_norm``     — HAMUR's (and STAR's) normalization by the current
                        batch's masked statistics, at train and eval time

A stacked bank (the JAX package's ``stacked_mlp_init``/``stacked_mlp_apply``)
is ``MLP(..., members=n)``: every parameter and running stat gains a leading
``[n, ...]`` axis and each layer is one batched matmul over it. A tuple
``members=(D, S)`` stacks twice, as PLE's per-domain specific experts
(the JAX package's two nested vmaps). Activations are ``[..., B, H]``:
``[B, H]`` for a plain MLP, ``[*members, B, H]`` inside a bank; statistics
reduce over the batch axis ``-2`` only.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
from torch import nn

from ..core import config as compute_config
from ..core import init as initializers
from ..core.activations import activation as activation_factory
from ..parallel.mesh import all_reduce_sum, current_step

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
LN_EPS = 1e-5


def _row(t: torch.Tensor) -> torch.Tensor:
    """A per-feature vector ``[..., H]`` as ``[..., 1, H]`` (broadcast over B)."""
    return t.unsqueeze(-2)


def linear(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``x @ w + b``; a shared ``x [B, in]`` broadcasts over stacked ``w``."""
    return compute_config.matmul(x, w) + _row(b)


def batch_stats(x: torch.Tensor, w: Optional[torch.Tensor] = None):
    """(mean, biased var, n) over the batch axis -2, excluding rows with
    ``w == 0``.

    Static-shape batches are padded with weight-0 rows (data/dataset.py);
    the reference never sees those rows, so every batch-statistics op must
    exclude them or train/eval semantics diverge on ragged batches.

    Inside a mesh step (``parallel.mesh_step``) ``x`` holds this rank's rows
    of the global batch, and the statistics are the global batch's, as in
    the JAX package's SPMD step: ``sum(w x)`` with ``sum(w)``, then ``sum(w
    (x - mean)^2)``, are summed over the ``data`` group, whose gradient is
    again that sum.
    """
    step = current_step()
    if step is not None:
        wc = (torch.ones(x.shape[-2], 1, dtype=x.dtype, device=x.device) if w is None
              else w.reshape(-1, 1).to(x.dtype))
        s1 = torch.sum(x * wc, dim=-2)
        both = all_reduce_sum(torch.cat([s1.reshape(-1), torch.sum(wc).reshape(1)]),
                              step.group)
        n = torch.clamp(both[-1], min=1.0)
        mean = both[:-1].reshape(s1.shape) / n
        var = all_reduce_sum(torch.sum(((x - _row(mean)) ** 2) * wc, dim=-2),
                             step.group) / n
        return mean, var, n
    if w is None:
        mean = torch.mean(x, dim=-2)
        var = torch.mean((x - _row(mean)) ** 2, dim=-2)
        return mean, var, torch.tensor(float(x.shape[-2]), device=x.device)
    wc = w.reshape(-1, 1).to(x.dtype)
    n = torch.clamp(torch.sum(wc), min=1.0)
    mean = torch.sum(x * wc, dim=-2) / n
    var = torch.sum(((x - _row(mean)) ** 2) * wc, dim=-2) / n
    return mean, var, n


def batchnorm(x, gamma, beta, mean, var, train: bool, w=None,
              momentum: float = BN_MOMENTUM):
    """torch BatchNorm1d: batch stats (biased var) normalize in train mode,
    running stats update with the *unbiased* var; eval uses running stats.
    ``w``: optional [B] 0/1 mask; padded rows are excluded from the stats
    (their outputs are garbage and must be discarded by the caller).
    ``momentum``: the running stats' EMA weight of the batch; ``1 - (1 -
    m)^n`` takes ``n`` identical updates of momentum ``m`` in one (HAMUR's
    shared hyper-network, which the reference runs once per domain).

    Returns ``(y, new_mean, new_var)``.
    """
    if train:
        bmean, bvar, n = batch_stats(x, w)
        y = (x - _row(bmean)) * torch.rsqrt(_row(bvar) + BN_EPS)
        unbiased = bvar * (n / torch.clamp(n - 1.0, min=1.0))
        new_mean = (1 - momentum) * mean + momentum * bmean
        new_var = (1 - momentum) * var + momentum * unbiased
    else:
        y = (x - _row(mean)) * torch.rsqrt(_row(var) + BN_EPS)
        new_mean, new_var = mean, var
    return y * _row(gamma) + _row(beta), new_mean, new_var


def layernorm(x, gamma, beta, eps: float = LN_EPS):
    """torch LayerNorm over the last axis, in the JAX package's operation
    order: ``(x - mean) * rsqrt(var + eps) * gamma + beta``, var biased."""
    mean = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean((x - mean) ** 2, dim=-1, keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def domain_norm(x, gamma, beta, eps: float, unbiased: bool = False, w=None):
    """``gamma * (x - mean) / sqrt(var + eps) + beta`` with the mean and var
    of the current batch (axis -2), at train and eval time alike; padded
    rows (``w == 0``) are excluded from them. ``unbiased``: HAMUR's adapters
    take torch's ``.var()`` (n - 1), STAR the biased mean square."""
    mean, var, n = batch_stats(x, w)
    if unbiased:
        var = var * (n / torch.clamp(n - 1.0, min=1.0))
    return gamma * ((x - _row(mean)) * torch.rsqrt(_row(var) + eps)) + beta


def dropout(x, p: float, train: bool, generator: Optional[torch.Generator]):
    """torch semantics: inverted scaling at train time. Inside a mesh step
    (``parallel.mesh_step``) every rank draws the global batch's mask from
    its copy of the shared generator and keeps its own rows (axis -2), so
    the masks are the single-process run's."""
    if not train or p <= 0.0:
        return x
    if generator is None:
        raise ValueError("dropout in train mode needs a torch.Generator")
    step = current_step()
    if step is not None:
        shape = x.shape[:-2] + (step.global_b,) + x.shape[-1:]
        keep = torch.rand(shape, generator=generator, device=x.device) < 1.0 - p
        keep = keep[..., step.row0:step.row0 + x.shape[-2], :]
        return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))
    keep = torch.rand(x.shape, generator=generator, device=x.device) < 1.0 - p
    return torch.where(keep, x / (1.0 - p), torch.zeros_like(x))


def _lead(members) -> tuple:
    """The member axes of ``members``: None, an int or a tuple of ints."""
    if members is None:
        return ()
    return tuple(int(m) for m in (members if isinstance(members, (tuple, list))
                                  else (members,)))


class Linear(nn.Module):
    def __init__(self, in_dim: int, out_dim: int, generator: torch.Generator,
                 lead=()):
        super().__init__()
        p = initializers.linear_params(generator, in_dim, out_dim, lead)
        self.w = nn.Parameter(p["w"])
        self.b = nn.Parameter(p["b"])

    def forward(self, x):
        return linear(x, self.w, self.b)


class BatchNorm(nn.Module):
    """BatchNorm1d with ``gamma``/``beta`` parameters and ``mean``/``var``
    running-stat buffers, all ``[*lead, dim]``. A train-mode forward updates
    the buffers in place, as torch's BatchNorm1d does."""

    def __init__(self, dim: int, lead=(), device=None):
        super().__init__()
        shape = tuple(lead) + (dim,)
        self.gamma = nn.Parameter(torch.ones(shape, device=device))
        self.beta = nn.Parameter(torch.zeros(shape, device=device))
        self.register_buffer("mean", torch.zeros(shape, device=device))
        self.register_buffer("var", torch.ones(shape, device=device))

    def forward(self, x, train: bool = False, w=None, momentum: float = BN_MOMENTUM):
        y, new_mean, new_var = batchnorm(x, self.gamma, self.beta, self.mean,
                                         self.var, train, w, momentum)
        if train:
            with torch.no_grad():
                self.mean.copy_(new_mean)
                self.var.copy_(new_var)
        return y


class LayerNorm(nn.Module):
    """:func:`layernorm` with ``gamma`` (ones) and ``beta`` (zeros)
    parameters of width ``dim``."""

    def __init__(self, dim: int, device=None):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones(dim, device=device))
        self.beta = nn.Parameter(torch.zeros(dim, device=device))

    def forward(self, x):
        return layernorm(x, self.gamma, self.beta)


class _Layer(nn.Module):
    def __init__(self, in_dim, out_dim, act, generator, lead):
        super().__init__()
        self.lin = Linear(in_dim, out_dim, generator, lead)
        self.bn = BatchNorm(out_dim, lead, device=generator.device)
        self.act = nn.ParameterDict(
            {k: nn.Parameter(v) for k, v in act.init(generator, lead).items()})


class MLP(nn.Module):
    """MLP matching the reference block: [Linear -> BatchNorm1d -> act ->
    Dropout]* then an optional ``(·, 1)`` head.

    ``members=n`` stacks ``n`` independent MLPs on a leading axis, and
    ``members=(n0, n1, ...)`` on several; the forward then returns
    ``[*members, B, out]``.
    """

    def __init__(
        self,
        input_dim: int,
        dims: Optional[Sequence[int]] = None,
        output_layer: bool = True,
        activation: str = "relu",
        dropout: float = 0.0,
        members=None,
        *,
        generator: torch.Generator,
    ):
        super().__init__()
        self.input_dim = int(input_dim)
        self.dims = tuple(dims or ())
        self.output_layer = bool(output_layer)
        self.act = activation_factory(activation)
        self.dropout_p = float(dropout)
        self.members = members
        self.output_dim = 1 if self.output_layer else (
            self.dims[-1] if self.dims else self.input_dim
        )
        self.lead = lead = _lead(members)
        layers = []
        in_dim = self.input_dim
        for d in self.dims:
            layers.append(_Layer(in_dim, d, self.act, generator, lead))
            in_dim = d
        self.layers = nn.ModuleList(layers)
        self.out = (Linear(in_dim, 1, generator, lead) if self.output_layer
                    else None)

    def forward(self, x, train: bool = False, w=None,
                generator: Optional[torch.Generator] = None,
                per_member_x: bool = False):
        """``x`` is ``[B, in]``, shared by every member of a bank, or with
        ``per_member_x=True`` ``[*lead[:k], B, in]`` fed member-wise over the
        first ``k`` member axes and shared over the rest (PLE feeds its
        ``[D, S]`` bank ``x [D, B, in]``: row ``d``'s ``S`` members all read
        ``x[d]``). ``w`` ([B] padding mask) is shared across members."""
        lead = self.lead
        if per_member_x:
            k = x.ndim - 2
            if not lead or not 1 <= k <= len(lead) or tuple(x.shape[:k]) != lead[:k]:
                raise ValueError(
                    f"per_member_x needs x [{', '.join(map(str, lead))}"
                    f"{'' if lead else '?'}, B, in] or a prefix of those member "
                    f"axes, got {tuple(x.shape)}")
            x = x.reshape(tuple(x.shape[:k]) + (1,) * (len(lead) - k)
                          + tuple(x.shape[k:]))
        for layer in self.layers:
            x = layer.lin(x)
            x = layer.bn(x, train, w)
            act_p = {k: (_row(v) if lead else v) for k, v in layer.act.items()}
            x = self.act.apply(act_p, x)
            x = dropout(x, self.dropout_p, train, generator)
        if self.out is not None:
            x = self.out(x)
        if tuple(x.shape[:-2]) != lead:
            x = x.expand(lead + tuple(x.shape[-2:]))
        return x


class GateNU(nn.Module):
    """PEPNet's gate (the JAX package's ``GateNU``):
    ``gemma * sigmoid(relu(x W1 + b1) W2 + b2)``, the hidden width the
    output width unless given. ``members=n`` stacks ``n`` gates, as MLP
    does: a shared ``x [B, in]`` then gives ``[n, B, out]``."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: Optional[int] = None,
                 gemma: float = 2.0, members=None, *, generator: torch.Generator):
        super().__init__()
        self.input_dim = int(input_dim)
        self.output_dim = int(output_dim)
        self.hidden_dim = self.output_dim if hidden_dim is None else int(hidden_dim)
        self.gemma = float(gemma)
        self.lead = _lead(members)
        self.l1 = Linear(self.input_dim, self.hidden_dim, generator, self.lead)
        self.l2 = Linear(self.hidden_dim, self.output_dim, generator, self.lead)

    def forward(self, x):
        return self.gemma * torch.sigmoid(self.l2(torch.relu(self.l1(x))))


class Pruner(nn.Module):
    """AdaSparse's pruner (the JAX package's ``Pruner``): a bias-free linear
    ``v = [sce ‖ h] W``, then

    - ``Binarization``: ``sign(sigmoid(v·alpha) - eps)``;
    - ``Scaling``: ``beta·sigmoid(v) · sign(beta·sigmoid(v) - eps)``;
    - ``Fusion``: ``beta·sigmoid(v·alpha) · sign(beta·sigmoid(v·alpha) - eps)``;

    the sign term detached (it has no gradient anyway); ``sign(0)`` is 0.
    """

    FORMS = ("Binarization", "Scaling", "Fusion")

    def __init__(self, sce_dims: int, agn_dims: int, form: str = "Binarization",
                 epsilon: float = 1e-2, beta: float = 2.0, *, generator: torch.Generator):
        super().__init__()
        if form not in self.FORMS:
            raise ValueError(f"The input 'form' must be one of {list(self.FORMS)}")
        self.sce_dims = int(sce_dims)
        self.agn_dims = int(agn_dims)
        self.form = form
        self.epsilon = float(epsilon)
        self.beta = float(beta)
        # bias=False linear: the weight of a Linear's draw
        p = initializers.linear_params(generator, self.sce_dims + self.agn_dims, self.agn_dims)
        self.w = nn.Parameter(p["w"])

    def forward(self, sce, h, alpha):
        vin = torch.cat([sce, h], dim=1) @ self.w
        if self.form == "Binarization":
            return torch.sign(torch.sigmoid(vin * alpha) - self.epsilon)
        if self.form == "Fusion":
            vin = vin * alpha
        vout = self.beta * torch.sigmoid(vin)
        return vout * torch.sign(vout - self.epsilon).detach()
