"""Carry weights from the JAX package into a port module.

The JAX package keeps a model's weights in ``(params, state)`` trees of
nested dicts and lists. :func:`load_jax_params` takes those trees with
**numpy** leaves (``jax.tree_util.tree_map(np.asarray, tree)``) and copies
every leaf into the module entry of the same path:

- ``embedding/packed`` and ``embedding/tables/<name>``;
- ``<bank>/layers[i]/{lin/{w,b}, bn/{gamma,beta}, act/...}`` and
  ``<bank>/out/{w,b}``;
- ``state/<bank>/layers[i]/{mean,var}``, the BatchNorm running stats,
  which the port keeps as ``layers.i.bn.{mean,var}`` buffers.

Paths are matched generically, so later models reuse it as long as their
modules are laid out like their JAX trees. Any shape mismatch, and any
entry missing or left over on either side, raises. No JAX is imported.
"""

from __future__ import annotations

import re
from typing import Dict

import numpy as np
import torch
from torch import nn

_BN_STAT = re.compile(r"(^|\.)(layers\.\d+)\.(mean|var)$")


def flatten_tree(tree, prefix: str = "") -> Dict[str, np.ndarray]:
    """``{"a": {"b": [x, y]}}`` -> ``{"a.b.0": x, "a.b.1": y}``; ``None``
    leaves and empty containers contribute nothing."""
    out: Dict[str, np.ndarray] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        out[prefix] = np.asarray(tree)
        return out
    for k, v in items:
        out.update(flatten_tree(v, f"{prefix}.{k}" if prefix else str(k)))
    return out


def load_jax_params(module: nn.Module, params, state=None) -> None:
    """Copy the JAX ``(params, state)`` trees into ``module`` in place."""
    src = flatten_tree(params)
    for path, arr in flatten_tree(state).items():
        key = _BN_STAT.sub(r"\1\2.bn.\3", path)
        if key in src:
            raise ValueError(f"state entry {path} collides with a parameter")
        src[key] = arr
    dst = module.state_dict()
    missing = sorted(set(dst) - set(src))
    extra = sorted(set(src) - set(dst))
    if missing or extra:
        raise KeyError(f"JAX tree and module differ: missing {missing}, "
                       f"left over {extra}")
    for key, arr in src.items():
        t = dst[key]
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: JAX shape {tuple(arr.shape)} != "
                             f"module shape {tuple(t.shape)}")
    with torch.no_grad():
        for key, arr in src.items():
            dst[key].copy_(torch.tensor(np.asarray(arr), dtype=dst[key].dtype))
