"""Row-sharded embedding lookup (the JAX package's
``parallel/sharded_embedding.py``).

Each rank of an ``embed`` group holds the contiguous rows ``[row0, row0 +
V/E)`` of the packed table. A lookup masks the ids to that range, gathers
locally, zeroes the rows outside it and sums over the ``embed`` group: one
collective a batch whatever the number of features. Exactly one rank
contributes each row and the others add zeros, so the rows equal a gather
from the whole table bit for bit.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_reduce_
from .sharding_rules import pad_vocab, shard_rows

__all__ = ["local_lookup", "make_sharded_lookup_fn", "pad_vocab", "sharded_lookup"]


@torch.no_grad()
def local_lookup(table_local: torch.Tensor, ids: torch.Tensor, row0: int) -> torch.Tensor:
    """This shard's part of the rows of global ``ids`` (any integer shape):
    its own rows where an id lies in ``[row0, row0 + V/E)``, zeros
    elsewhere; ``ids.shape + (D,)`` in float32 (exact for bf16 tables)."""
    vl = table_local.shape[0]
    local = ids.long() - int(row0)
    inside = (local >= 0) & (local < vl)
    rows = table_local[local.clamp(0, vl - 1)].float()
    return torch.where(inside[..., None], rows, torch.zeros((), device=rows.device))


@torch.no_grad()
def sharded_lookup(table_local: torch.Tensor, ids: torch.Tensor, row0: int,
                   group) -> torch.Tensor:
    """The rows of global ``ids`` (any integer shape) from this rank's shard
    ``table_local`` (``[V/E, D]``, the table's rows from ``row0``): the
    :func:`local_lookup` parts summed over ``group``, ``ids.shape + (D,)``
    in the table's type. A bf16 table is summed in float32 (one nonzero a
    row: exact either way). ``group`` None: the shard is the whole table."""
    if group is None:
        return table_local[ids.long() - int(row0)]
    return all_reduce_(local_lookup(table_local, ids, row0), group).to(table_local.dtype)


def make_sharded_lookup_fn(mesh: Mesh, table: torch.Tensor):
    """``(table_local, lookup)`` for tests: this rank's row shard of the whole
    ``table`` (padded to a multiple of the ``embed`` size), and ``lookup(
    table_local, ids) -> rows`` over the mesh's ``embed`` group."""
    local, row0 = shard_rows(table, mesh)

    def lookup(table_local, ids):
        return sharded_lookup(table_local, ids, row0, mesh.embed_group)

    return local, lookup
