"""Activation functions as (init, apply) pairs.

Same registry as the JAX package: sigmoid / relu / dice / prelu /
softmax(dim=1) / leakyrelu(0.1). Dice and PReLU carry learnable parameters,
so every activation is a spec with ``init(gen, lead) -> {name: tensor}`` and
``apply(params, x) -> y``; stateless activations return ``{}``. ``lead`` is
the leading member shape of a stacked bank. ``apply`` works on the last
axis, so a stacked ``[n, B, H]`` input behaves as ``n`` independent
``[B, H]`` ones (whose feature axis is 1) as long as the parameters
broadcast over ``B``.
"""

from __future__ import annotations

import torch


class Activation:
    def __init__(self, name, init_fn, apply_fn):
        self.name = name
        self.init = init_fn
        self.apply = apply_fn

    def __repr__(self):  # pragma: no cover
        return f"<Activation {self.name}>"


def _no_params(gen, lead=()):
    return {}


def _dice_init(gen, lead=()):
    # reference Dice: alpha = nn.Parameter(torch.randn(1))
    return {"alpha": torch.randn(tuple(lead) + (1,), generator=gen,
                                 device=gen.device, dtype=torch.float32)}


def _dice_apply(params, x, epsilon: float = 1e-3):
    """Dice from the DIN paper, with the reference's exact math: var is the
    *sum* over features of ``(x - mean)^2 + eps`` (eps added per element
    before the sum, and no division by feature count)."""
    avg = torch.mean(x, dim=-1, keepdim=True)
    var = torch.sum((x - avg) ** 2 + epsilon, dim=-1, keepdim=True)
    ps = torch.sigmoid((x - avg) / torch.sqrt(var))
    return ps * x + (1 - ps) * params["alpha"] * x


def _prelu_init(gen, lead=()):
    # torch nn.PReLU default: single weight initialised to 0.25
    return {"alpha": torch.full(tuple(lead) + (1,), 0.25, device=gen.device,
                                dtype=torch.float32)}


def _prelu_apply(params, x):
    return torch.where(x >= 0, x, params["alpha"] * x)


def leaky_relu(x):
    """torch ``LeakyReLU(0.1)``, as the JAX package writes it:
    ``where(x >= 0, x, 0.1 x)``."""
    return torch.where(x >= 0, x, 0.1 * x)


_REGISTRY = {
    "sigmoid": Activation("sigmoid", _no_params, lambda p, x: torch.sigmoid(x)),
    "relu": Activation("relu", _no_params, lambda p, x: torch.relu(x)),
    "dice": Activation("dice", _dice_init, _dice_apply),
    "prelu": Activation("prelu", _prelu_init, _prelu_apply),
    # reference nn.Softmax(dim=1), always applied to 2-D gate logits
    "softmax": Activation("softmax", _no_params,
                          lambda p, x: torch.softmax(x, dim=-1)),
    "leakyrelu": Activation("leakyrelu", _no_params, lambda p, x: leaky_relu(x)),
}


def activation(name) -> Activation:
    """String -> Activation factory."""
    if isinstance(name, Activation):
        return name
    key = name.lower()
    if key not in _REGISTRY:
        raise NotImplementedError(f"activation '{name}' not supported")
    return _REGISTRY[key]
