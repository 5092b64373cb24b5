"""Which tensors a mesh row-shards (the JAX package's
``parallel/sharding_rules.py``).

The dense stacks are small and stay replicated on every rank; the batch is
sharded over ``data``; the packed embedding table is the one tensor that
scales with the vocabulary (Ali-CCP: 23 x 467k rows), so it is row-sharded
over ``embed``; the sorted update's Adam moments and, with bf16 storage, its
bf16 table are made from that shard and so are row-sharded alike.

The port keeps its plain ``[V, D]`` layout: ``V`` is padded with zero rows
to a multiple of the ``embed`` size (``pad_vocab``) and rank ``e`` holds
rows ``[e V/E, (e + 1) V/E)``. The JAX package's whole-block tile padding
(``pack_rows(n_shards=)``) is a TPU layout and is not carried over.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from .mesh import Mesh, all_gather_rows

# the model's row-sharded parameter
ROW_SHARDED_PARAM = "embedding.packed"


def param_specs(model) -> Dict[str, str | None]:
    """``{state_dict key: "embed" | None}``: the packed table of the model's
    ``embedding`` collection is row-sharded over ``embed``, everything else
    replicated (None)."""
    return {k: ("embed" if k == ROW_SHARDED_PARAM else None) for k in model.state_dict()}


def pad_vocab(vocab: int, n_shards: int) -> int:
    """``vocab`` rounded up to a multiple of ``n_shards``."""
    return -(-vocab // n_shards) * n_shards


def shard_range(v: int, mesh: Mesh) -> Tuple[int, int]:
    """``(row0, rows)`` of this rank's shard of a ``v``-row table."""
    e = mesh.shape["embed"]
    rows = pad_vocab(v, e) // e
    return mesh.embed_index * rows, rows


def shard_rows(full: torch.Tensor, mesh: Mesh) -> Tuple[torch.Tensor, int]:
    """``(local, row0)``: this rank's ``[V/E, ...]`` rows of ``full``
    (``[V, ...]``, zero rows padded past V), a contiguous copy."""
    row0, rows = shard_range(full.shape[0], mesh)
    pad = row0 + rows - full.shape[0]
    src = full[row0:row0 + rows]
    if pad > 0:
        src = F.pad(src, (0, 0) * (full.ndim - 1) + (0, pad))
    return src.detach().clone(memory_format=torch.contiguous_format), row0


def gather_rows(local: torch.Tensor, mesh: Mesh, v: int) -> torch.Tensor:
    """The inverse of :func:`shard_rows` over the ``embed`` group: the first
    ``v`` rows of the shards concatenated in rank order."""
    return all_gather_rows(local, mesh.embed_group)[:v]
