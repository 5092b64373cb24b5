"""Parameter initializers.

Each initializer is a function ``(generator, shape) -> torch.Tensor`` (f32),
drawn on ``generator.device``. The distribution families are those of the
JAX package (torch's ``nn.Linear``/kaiming defaults); the draws come from
the ``torch.Generator``, so the bits differ from JAX's and the tests compare
distributions, or copy weights across (``interop.py``).

torch fan convention for a 2-D tensor: ``fan_in = shape[1]``,
``fan_out = shape[0]``. Several reference models store weight matrices as
``(in, out)`` and call torch initializers on them, which makes torch's
"fan_in" actually the *output* dim; `kaiming_uniform_torch` reproduces that
quirk on purpose.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _normal(gen: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=gen, device=gen.device,
                       dtype=torch.float32)


def _uniform(gen: torch.Generator, shape, lo: float, hi: float) -> torch.Tensor:
    u = torch.rand(tuple(shape), generator=gen, device=gen.device,
                   dtype=torch.float32)
    return u * (hi - lo) + lo


def random_normal(mean: float = 0.0, std: float = 1.0):
    def _init(gen, shape):
        return mean + std * _normal(gen, shape)

    return _init


def random_uniform(minval: float = 0.0, maxval: float = 1.0):
    def _init(gen, shape):
        return _uniform(gen, shape, minval, maxval)

    return _init


def _torch_fans(shape):
    """torch _calculate_fan_in_and_fan_out for 2-D tensors."""
    assert len(shape) >= 2, "fan init needs >= 2 dims"
    fan_in = shape[1]
    fan_out = shape[0]
    if len(shape) > 2:
        receptive = math.prod(shape[2:])
        fan_in *= receptive
        fan_out *= receptive
    return fan_in, fan_out


def xavier_normal(gain: float = 1.0):
    def _init(gen, shape):
        fan_in, fan_out = _torch_fans(shape)
        std = gain * math.sqrt(2.0 / (fan_in + fan_out))
        return std * _normal(gen, shape)

    return _init


def xavier_uniform(gain: float = 1.0):
    def _init(gen, shape):
        fan_in, fan_out = _torch_fans(shape)
        bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
        return _uniform(gen, shape, -bound, bound)

    return _init


def kaiming_uniform_torch(a: float = 0.0):
    """torch ``init.kaiming_uniform_`` with fan computed torch-style.

    Default ``a=0`` + leaky_relu gain = sqrt(2) -> bound = sqrt(6 / fan) where
    ``fan = shape[1]`` (applied to ``(in, out)`` matrices, so "fan" is the
    layer's output width, preserved deliberately).
    """

    def _init(gen, shape):
        fan = _torch_fans(shape)[0]
        gain = math.sqrt(2.0 / (1.0 + a * a))
        bound = gain * math.sqrt(3.0 / fan)
        return _uniform(gen, shape, -bound, bound)

    return _init


def pretrained(weight, freeze: bool = True):
    """Initializer returning a fixed pretrained table.

    ``freeze`` is carried on the initializer for the trainer's freeze
    machinery, which arrives with training. Reference:
    ``nn.Embedding.from_pretrained(..., freeze=True)``.
    """
    weight = torch.as_tensor(np.asarray(weight, dtype=np.float32))

    def _init(gen, shape):
        assert tuple(shape) == tuple(weight.shape), (
            f"pretrained weight shape {tuple(weight.shape)} != requested {shape}"
        )
        return weight.to(gen.device).clone()

    _init.freeze = freeze  # type: ignore[attr-defined]
    return _init


def linear_params(gen: torch.Generator, in_dim: int, out_dim: int,
                  lead=()):
    """Weight ``(*lead, in, out)`` + bias ``(*lead, out)`` matching
    torch.nn.Linear defaults: W, b ~ U(-1/sqrt(in), 1/sqrt(in)).

    W is stored (in, out) so forward is ``x @ W + b``; ``lead`` adds the
    leading member axis of a stacked bank.
    """
    bound = 1.0 / math.sqrt(in_dim) if in_dim > 0 else 0.0
    lead = tuple(lead)
    w = _uniform(gen, lead + (in_dim, out_dim), -bound, bound)
    b = _uniform(gen, lead + (out_dim,), -bound, bound)
    return {"w": w, "b": b}
