"""Row-sharded embedding lookup (the JAX package's
``parallel/sharded_embedding.py``).

Each rank of an ``embed`` group holds the contiguous rows ``[row0, row0 +
V/E)`` of the packed table. A lookup masks the ids to that range, gathers
locally, zeroes the rows outside it and sums over the ``embed`` group: one
collective a batch whatever the number of features. Exactly one rank
contributes each row and the others add zeros, so the rows equal a gather
from the whole table bit for bit.

:func:`sharded_gather` is the lookup a model's embedding collection makes
once a trainer has placed it on a mesh: with gradients on it is
differentiable (:class:`ShardedLookup`), its backward the accumulating
scatter of the rows' gradients into this shard's gradient alone. No
collective runs there: every ``embed`` rank of a data row holds the same
batch and receives the same upstream gradient, so each shard's gradient is
complete on its own rank (the trainer sums it over ``data`` with the dense
gradients). :func:`sharded_lookup` (no gradient) serves the sparse updates'
rows and eval.
"""

from __future__ import annotations

import torch

from .mesh import Mesh, all_reduce_
from .sharding_rules import pad_vocab, shard_rows

__all__ = ["ShardedLookup", "local_lookup", "make_sharded_lookup_fn", "pad_vocab",
           "sharded_gather", "sharded_lookup"]


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


class ShardedLookup(torch.autograd.Function):
    """:func:`sharded_lookup` with a gradient for ``table_local``: the
    rows' gradients added into a ``[V/E, D]`` zero tensor at the ids that
    fall in the shard, by the accumulating ``index_put_`` that a whole
    table's gather takes in its backward (so each row sums its occurrences
    in the same order); the other ids go to a spare row past the shard,
    which is dropped. No collective (see the module docstring)."""

    @staticmethod
    def forward(ctx, table_local, ids, row0, group):
        ctx.save_for_backward(ids)
        ctx.row0, ctx.rows = int(row0), table_local.shape[0]
        return sharded_lookup(table_local, ids, row0, group)

    @staticmethod
    def backward(ctx, grad):
        (ids,) = ctx.saved_tensors
        vl, d = ctx.rows, grad.shape[-1]
        local = ids.reshape(-1).long() - ctx.row0
        local = torch.where((local >= 0) & (local < vl), local, vl)
        g = grad.new_zeros((vl + 1, d)).index_put_((local,), grad.reshape(-1, d),
                                                   accumulate=True)
        return g[:vl], None, None, None


def sharded_gather(table_local: torch.Tensor, ids: torch.Tensor, row0: int,
                   group) -> torch.Tensor:
    """The rows of global ``ids`` from this rank's shard, as
    :func:`sharded_lookup`; differentiable in ``table_local`` where
    gradients are on and it requires them (:class:`ShardedLookup`).
    ``group`` None: the shard is the whole table, an ordinary gather."""
    if group is None:
        return table_local[ids.long() - int(row0)]
    if torch.is_grad_enabled() and table_local.requires_grad:
        return ShardedLookup.apply(table_local, ids, int(row0), group)
    return sharded_lookup(table_local.detach(), ids, row0, group)


def make_sharded_lookup_fn(mesh: Mesh, table: torch.Tensor):
    """``(table_local, lookup)`` for tests: this rank's row shard of the whole
    ``table`` (padded to a multiple of the ``embed`` size), and ``lookup(
    table_local, ids) -> rows`` over the mesh's ``embed`` group."""
    local, row0 = shard_rows(table, mesh)

    def lookup(table_local, ids):
        return sharded_lookup(table_local, ids, row0, mesh.embed_group)

    return local, lookup
