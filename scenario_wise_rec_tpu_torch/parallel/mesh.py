"""The process mesh of multi-GPU training (the JAX package's
``parallel/mesh.py``).

The JAX package lays its devices out as a named ``(data, embed)`` mesh: the
batch is sharded over ``data`` (XLA inserts the gradient all-reduce) and the
packed embedding table is row-sharded over ``embed``. The port runs one
process per mesh position, joined by ``torch.distributed``:

- :func:`init_distributed` starts the process group; its backend is always
  the caller's choice, ``"nccl"`` (one card a rank) or ``"gloo"`` (which
  stages the collectives of CUDA tensors through the host, so several ranks
  may share one card);
- :func:`make_mesh` lays the ``world_size`` ranks out as JAX's
  ``devices.reshape(n_data, n_embed)`` does: rank ``d * n_embed + e`` sits
  at ``(d, e)``. Its :class:`Mesh` holds two kinds of subgroup: a ``data``
  group is the ranks of one ``e`` (they hold the same table shard and see
  different batch rows), an ``embed`` group the ranks of one ``d`` (they
  see the same batch rows and hold different shards). A mesh of world size
  1 needs no process group;
- :func:`replicate` broadcasts tensors from rank 0; :func:`shard_batch_fn`
  and :func:`shard_stacked_batch_fn` take this rank's rows of a global
  ``[B]`` or ``[S, B]`` batch;
- :func:`mesh_step` is the context a trainer sets around a mesh step or
  an eval batch: the batch statistics and dropout of ``ops/nn.py``, the
  loss of ``train/loss.py``, the attention of ``ops/transformer.py`` (its
  keys and values gathered by :func:`all_gather_rows_autograd`) and
  AdaptDHM's center update read it (:func:`current_step`) and reduce over
  the ``data`` group, so that a step sees the global batch as JAX's SPMD
  step does.

The collectives here take a group that may be None (a group of one rank:
nothing to exchange). Each exchange runs inside a named profiler range
(``mesh.all_reduce_``, ``mesh.all_gather_rows``, ``mesh.broadcast_``), so a
trace (``train/profiling.py``) shows a rank's time in its collectives; a
range records on the host only.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass
from typing import Iterable, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.profiler import record_function

BACKENDS = ("nccl", "gloo")


def init_distributed(backend: str, init_method: str, rank: int,
                     world_size: int) -> torch.device:
    """Join the process group of ``world_size`` ranks on this host and
    return the device this rank computes on.

    ``backend``: ``"nccl"`` or ``"gloo"``, never chosen here.
    ``init_method``: e.g. ``"tcp://localhost:29500"`` or ``"file:///tmp/x"``.
    With a card present a rank computes on ``cuda:(rank % cards)``; NCCL
    refuses two ranks on one card, so asking for it when the ranks
    outnumber the cards raises ``ValueError`` (gloo runs them).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend == "nccl" and world_size > cards:
        raise ValueError(f"nccl needs a card a rank: {world_size} ranks, {cards} cards; "
                         "pass backend='gloo' to share a card")
    device = torch.device("cuda", rank % cards) if cards else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)
    return device


class Mesh:
    """``n_data x n_embed`` ranks (see the module docstring). ``rank``,
    ``data_index`` (d) and ``embed_index`` (e) place this process;
    ``data_group`` and ``embed_group`` are its subgroups (None when of one
    rank), ``group`` the world's (None at world size 1); ``backend`` the
    process group's, or None."""

    def __init__(self, n_data: int, n_embed: int, rank: int, data_group, embed_group,
                 group, backend: Optional[str]):
        self.shape = {"data": n_data, "embed": n_embed}
        self.rank = rank
        self.data_index, self.embed_index = divmod(rank, n_embed)
        self.data_group, self.embed_group, self.group = data_group, embed_group, group
        self.backend = backend

    def __repr__(self):
        return (f"Mesh(data={self.shape['data']}, embed={self.shape['embed']}, "
                f"rank={self.rank}, backend={self.backend})")


def make_mesh(n_data: Optional[int] = None, n_embed: int = 1) -> Mesh:
    """The ``(data, embed)`` mesh over the process group's ranks (one rank
    without a group). Every rank must call it, in the same order as its
    other group calls: it makes every subgroup."""
    initialized = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if initialized else 1
    rank = dist.get_rank() if initialized else 0
    if n_data is None:
        n_data = world // n_embed
    if n_data < 1 or n_embed < 1 or n_data * n_embed != world:
        raise ValueError(f"mesh {n_data}x{n_embed} != {world} ranks")
    grid = np.arange(world).reshape(n_data, n_embed)
    d, e = divmod(rank, n_embed)
    data_group = embed_group = None
    if n_data > 1:
        for col in range(n_embed):
            g = dist.new_group(grid[:, col].tolist())
            if col == e:
                data_group = g
    if n_embed > 1:
        for row in range(n_data):
            g = dist.new_group(grid[row].tolist())
            if row == d:
                embed_group = g
    return Mesh(n_data, n_embed, rank, data_group, embed_group,
                dist.group.WORLD if world > 1 else None,
                dist.get_backend() if initialized else None)


# -- collectives -------------------------------------------------------------

def all_reduce_(t: torch.Tensor, group) -> torch.Tensor:
    """Sum ``t`` over ``group`` in place."""
    if group is not None:
        with record_function("mesh.all_reduce_"):
            dist.all_reduce(t, group=group)
    return t


class _AllReduceSum(torch.autograd.Function):
    """The sum over a group, whose gradient is the sum of the gradients over
    the group (each rank's loss reaches the sum on every rank)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce_(t.clone(), group)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce_(grad.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``, differentiable (a new tensor)."""
    return t if group is None else _AllReduceSum.apply(t, group)


def all_gather_rows(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0, in the group's rank
    order (a new tensor; ``t`` itself for a group of one)."""
    if group is None:
        return t
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    with record_function("mesh.all_gather_rows"):
        dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


class _AllGatherRows(torch.autograd.Function):
    """:func:`all_gather_rows` with a gradient: every rank's loss reads the
    gathered rows, so the gradient of this rank's rows is the sum of the
    gathered tensor's gradients over the group, at this rank's rows (the
    sum is :func:`all_reduce_`'s, as :class:`_AllReduceSum`'s backward)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group, ctx.rows = group, t.shape[0]
        ctx.row0 = dist.get_rank(group) * t.shape[0]
        return all_gather_rows(t, group)

    @staticmethod
    def backward(ctx, grad):
        g = all_reduce_(grad.contiguous().clone(), ctx.group)
        return g[ctx.row0:ctx.row0 + ctx.rows], None


def all_gather_rows_autograd(t: torch.Tensor, group) -> torch.Tensor:
    """:func:`all_gather_rows`, differentiable in ``t`` (every rank's rows
    of one size); ``t`` itself for a group of one."""
    return t if group is None else _AllGatherRows.apply(t, group)


def same_on_every_rank(mesh: Mesh, value, what: str) -> None:
    """Raise ``ValueError`` on every rank unless every rank of the mesh
    passes an equal ``value`` (any picklable value; one collective)."""
    if mesh.group is None:
        return
    seen = [None] * dist.get_world_size(mesh.group)
    dist.all_gather_object(seen, value, group=mesh.group)
    if any(v != seen[0] for v in seen):
        raise ValueError(f"the mesh's ranks disagree on {what}: {seen}")


def broadcast_(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """``t`` of global rank ``src``, in place on every rank of ``group``."""
    if group is not None:
        with record_function("mesh.broadcast_"):
            dist.broadcast(t, src=src, group=group)
    return t


def replicate(mesh: Mesh, tensors: Iterable[torch.Tensor]) -> None:
    """Give every rank rank 0's values of ``tensors`` (in place, all of one
    float or int type each)."""
    for t in tensors:
        with torch.no_grad():
            broadcast_(t.data, mesh.group)


def broadcast_object(mesh: Mesh, obj):
    """Rank 0's ``obj`` (any picklable value) on every rank."""
    if mesh.group is None:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0, group=mesh.group)
    return box[0]


def barrier(mesh: Mesh) -> None:
    """Wait until every rank of the mesh arrives."""
    if mesh.group is not None:
        dist.barrier(group=mesh.group)


# -- batches -----------------------------------------------------------------

def local_rows(mesh: Mesh, b: int) -> slice:
    """This rank's rows of a global batch of ``b``: the ``d``-th of
    ``n_data`` equal slices. ``b`` must divide by ``n_data``."""
    n = mesh.shape["data"]
    if b % n:
        raise ValueError(f"the global batch of {b} rows does not divide over the mesh's "
                         f"{n} data ranks")
    bl = b // n
    return slice(mesh.data_index * bl, (mesh.data_index + 1) * bl)


def shard_batch_fn(mesh: Mesh):
    """``(x, y, w) -> (x, y, w)`` of this rank's rows (dim 0); numpy arrays
    and tensors alike, views where they can be."""
    def shard(x, y, w):
        rows = local_rows(mesh, len(w))
        return ({k: v[rows] for k, v in x.items()}, None if y is None else y[rows], w[rows])

    return shard


def shard_stacked_batch_fn(mesh: Mesh):
    """Like :func:`shard_batch_fn` for ``[S, B, ...]`` batches: the steps
    stay whole, dim 1 is sharded."""
    def shard(x, y, w):
        rows = local_rows(mesh, w.shape[1])
        return ({k: v[:, rows] for k, v in x.items()},
                None if y is None else y[:, rows], w[:, rows])

    return shard


# -- the step context --------------------------------------------------------

@dataclass(frozen=True)
class MeshStep:
    """What a mesh step's batch statistics, dropout and loss need: the
    ``data`` group to reduce over, this rank's first row in the global
    batch and the global batch's rows."""
    group: object
    row0: int
    global_b: int


_STEP: Optional[MeshStep] = None


@contextlib.contextmanager
def mesh_step(mesh: Mesh, b_local: int):
    """Inside: :func:`current_step` is this rank's :class:`MeshStep` for a
    local batch of ``b_local`` rows."""
    global _STEP
    prev = _STEP
    _STEP = MeshStep(mesh.data_group, mesh.data_index * b_local,
                     b_local * mesh.shape["data"])
    try:
        yield _STEP
    finally:
        _STEP = prev


def current_step() -> Optional[MeshStep]:
    """The :class:`MeshStep` of the mesh step under way, or None."""
    return _STEP
