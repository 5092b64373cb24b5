"""Optimizers matching the reference's torch defaults (the JAX package's
``train/optim.py``).

The reference uses ``torch.optim.Adam(lr=1e-3, weight_decay=1e-5)``
(ctr_trainer.py:50-52): weight decay is added to the *gradient* before the
moment updates (Adam, not AdamW). The JAX package writes that as an optax
chain; here it is ``torch.optim.Adam`` itself.

The sparse embedding updates keep the packed table out of that optimizer
and update it from the batch's per-occurrence gradient rows (``g_rows
[K, D]``, the gradient with respect to ``table[ids]``), in place:

- exact dense Adam on every row (the reference's semantics):
  :func:`sorted_dense_adam_update` (one global id sort, the kernel of
  ``ops/kernels/sorted_adam.py``; on a mesh its row-sharded form on this
  rank's shard) and :func:`fused_dense_adam_update`
  (per-segment sorts, the kernel of ``ops/kernels/fused_adam.py``), with
  ``{"mu", "nu", "step"}`` state beside the model's own ``[V, D]`` table
  (or, for the sorted update with bf16 storage, a bf16 store
  ``{"table", "mu", "nu", "step"}`` of its own: :func:`sorted_dense_adam_init`);
- lazy row-sparse Adam (``torch.optim.SparseAdam``'s semantics: only the
  touched rows move, untouched rows take no weight decay and their moments
  no decay): :func:`sparse_adam_rowgrads_update` (a winner scatter, the
  rows written back by ``scatter_rows`` of ``ops/kernels/row_update.py``)
  and :func:`sparse_adam_occurrence_update` (a combined ``[V, 3·D]`` row
  store, both kernels of ``ops/kernels/row_update.py``).

Every update takes ``frozen_spans``, the packed rows of frozen pretrained
tables, which keep their weights and moments (``train/freeze.py``). Every
update takes ``mesh=`` too: the table and its state are then this rank's
row shard, and the update gathers the ids and gradient rows over the mesh's
``data`` axis into the global batch's layout (:func:`global_rows`,
:func:`global_segments`), sums and elects in that layout, and steps or
writes back the rows that fall in its shard only (:func:`shard_spans`,
:func:`shard_local_ids`), so a (1, E) mesh equals one process bit for bit. The step
count is a host int, so no update syncs with the card. Every update also
takes its step's Adam numbers as a row on the device (``hp=``), which a CUDA
graph of the train step replays with each step's row; the caller then
advances the step count. (The TPU kept the
sorted table padded in a packed ``[V2/r, 128]`` layout; that layout is not
carried over, so eval reads the live table directly.)

The reference passes StepLR ``scheduler_params`` but never a
``scheduler_fn``, so its lr is constant; :func:`step_lr` is provided for
capability parity.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..ops.kernels.fused_adam import DEFAULT_BLOCK_ROWS as FUSED_BLOCK_ROWS
from ..ops.kernels.fused_adam import fused_dense_adam_apply, fused_dense_adam_apply_sharded
from ..ops.kernels.row_update import occurrence_segsum, scatter_rows
from ..ops.kernels.sorted_adam import (adam_hparams, owner_sorted_grads,
                                       sorted_dense_adam_apply,
                                       sorted_dense_adam_apply_sharded)
from ..parallel.mesh import all_gather_rows
from .freeze import frozen_ids_mask, rows_kept

Spans = Sequence[Tuple[int, int]]


def adam(lr: float = 1e-3, weight_decay: float = 1e-5, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8):
    """A ``params -> torch.optim.Adam`` factory: torch-Adam with weight decay
    folded into the gradient, the math of the JAX package's
    ``add_decayed_weights`` + ``scale_by_adam`` chain."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def step_lr(step_size: int, gamma: float):
    """StepLR multiplier ``gamma ** (epoch // step_size)`` of the *epoch*
    index (the reference steps its scheduler once per epoch,
    ctr_trainer.py:83-86)."""

    def schedule(epoch):
        return gamma ** (epoch // step_size)

    return schedule


def sparse_adam_init(table: torch.Tensor) -> Dict:
    """Optimizer state of the winner, dense and sorted updates: zero
    ``[V, D]`` moments beside the table and a host step count."""
    return {"mu": torch.zeros_like(table, memory_format=torch.contiguous_format),
            "nu": torch.zeros_like(table, memory_format=torch.contiguous_format),
            "step": 0}


def sorted_dense_adam_init(table: torch.Tensor, dtype=None) -> Dict:
    """Optimizer state of the sorted update. With ``dtype=None`` (or float32)
    that of :func:`sparse_adam_init`: the update steps the model's own
    table. With ``dtype=torch.bfloat16`` the state is a bf16 store of its
    own, ``{"table", "mu", "nu", "step"}``: the table rounded to bf16 (to
    nearest even) and zero bf16 moments, which the update steps in place of
    the model's table (the JAX package's ``sorted_dense_adam_init(dtype=)``;
    its packed padded tile layout is not carried over)."""
    if dtype in (None, torch.float32):
        return sparse_adam_init(table)
    if dtype != torch.bfloat16:
        raise ValueError(f"sorted storage is float32 or bfloat16, got {dtype}")
    store = table.detach().to(dtype, memory_format=torch.contiguous_format)
    return {"table": store, "mu": torch.zeros_like(store),
            "nu": torch.zeros_like(store), "step": 0}


def _bias_corrections(step: int, b1: float, b2: float) -> Tuple[float, float]:
    """``(1 - b1^t, 1 - b2^t)`` in float32 on the host, as the JAX package
    computes them from its int32 step."""
    f, t = np.float32, np.float32(step)
    return float(f(1.0) - f(b1) ** t), float(f(1.0) - f(b2) ** t)


def occurrence_hparams_rows(step0: int, n: int, lr: float, b1: float,
                            b2: float) -> np.ndarray:
    """``[n, 3]`` float32: row ``i`` is ``(lr, 1 - b1^t, 1 - b2^t)`` of step
    ``t = step0 + i`` (:func:`_bias_corrections`), the numbers that change
    from step to step in :func:`sparse_adam_occurrence_update`; the
    companion of ``adam_hparams_rows`` (``ops/kernels/sorted_adam.py``)."""
    return np.array([(lr,) + _bias_corrections(step0 + i, b1, b2) for i in range(n)],
                    np.float32).reshape(n, 3)


def _staged_row(row: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host row on ``device``: on a card from pinned memory with
    ``non_blocking=True``, so the copy neither syncs the stream nor blocks
    the host."""
    t = torch.from_numpy(row)
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _rows_adam_core(table, opt_state, g, gather_ids, scatter_ids, hp, weight_decay,
                    b1, b2, eps):
    """The shared torch-Adam row math: gather the rows and moments at
    ``gather_ids``, update with the step's ``hp`` row ``(lr, 1 - b1^t, 1 -
    b2^t)`` on the table's device, and write the table and both moments back
    at ``scatter_ids`` by ``scatter_rows`` (ids outside ``[0, V)`` dropped,
    no mask: nothing reads the host). ``scatter_ids`` may repeat only ids
    outside ``[0, V)``. In place."""
    lr_t, bc1, bc2 = hp[0], hp[1], hp[2]
    with torch.no_grad():
        p = table[gather_ids]
        if weight_decay:
            g = g + weight_decay * p  # torch Adam: decay folded into the gradient
        mu = b1 * opt_state["mu"][gather_ids] + (1 - b1) * g
        nu = b2 * opt_state["nu"][gather_ids] + (1 - b2) * (g * g)
        update = lr_t * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        scatter_rows(table.detach(), scatter_ids, p - update)
        scatter_rows(opt_state["mu"], scatter_ids, mu)
        scatter_rows(opt_state["nu"], scatter_ids, nu)


def _own_row(opt_state, device, lr, b1, b2) -> Tuple[int, torch.Tensor]:
    """The next step count and its ``[3]`` row of Adam numbers
    (:func:`occurrence_hparams_rows`) staged on ``device`` without a sync."""
    step = int(opt_state["step"]) + 1
    return step, _staged_row(occurrence_hparams_rows(step, 1, lr, b1, b2)[0], device)


def sparse_adam_rows_update(table, opt_state, g_dense, ids, lr: float = 1e-3,
                            weight_decay: float = 1e-5, b1: float = 0.9,
                            b2: float = 0.999, eps: float = 1e-8):
    """Lazy (row-sparse) Adam from a dense gradient ``g_dense [V, D]``: only
    the rows in ``ids`` (duplicates allowed) move, with torch-Adam math and
    the global step's bias correction (``torch.optim.SparseAdam``'s
    semantics). In place; returns ``(table, opt_state)``."""
    sids = torch.sort(ids)[0]
    first = torch.ones_like(sids, dtype=torch.bool)
    first[1:] = sids[1:] != sids[:-1]
    # duplicates write nothing: their rows compute identical updates
    scatter_ids = torch.where(first, sids, table.shape[0])
    step, hp = _own_row(opt_state, table.device, lr, b1, b2)
    _rows_adam_core(table, opt_state, g_dense[sids], sids, scatter_ids, hp, weight_decay,
                    b1, b2, eps)
    opt_state["step"] = step
    return table, opt_state


def sparse_adam_rowgrads_update(table, opt_state, g_rows, ids, lr: float = 1e-3,
                                weight_decay: float = 1e-5, b1: float = 0.9,
                                b2: float = 0.999, eps: float = 1e-8,
                                frozen_spans: Spans = (),
                                hp: Optional[torch.Tensor] = None,
                                mesh=None, segments=()):
    """Lazy Adam from the per-occurrence rows ``g_rows [K, D]`` of ``ids
    [K]`` (the ``winner`` update): one occurrence of each id is elected its
    winner by a scatter into an O(V) scratch, every occurrence's gradient is
    summed into its winner's slot, and Adam runs at the winner slots only;
    ``scatter_rows`` writes the table and both moments back at them (3
    launches on the card). Frozen ids write nothing. In place; returns
    ``(table, opt_state)``.

    The step's Adam numbers are read from a ``[3]`` float32 row on the
    table's device, as in :func:`sparse_adam_occurrence_update`. ``hp``:
    that row, as the trainer's CUDA graphs replay this call with each step's
    row; ``lr`` is then unused and ``opt_state["step"]`` is left to the
    caller. Without ``hp`` the update stages its step's row itself, so an
    eager step and a replay compute alike. Nothing here reads the host, so
    the step can be captured.

    ``mesh`` (a ``parallel.Mesh``): ``table`` and both moments are this
    rank's row shard, ``ids``/``g_rows`` this rank's batch rows laid out as
    ``segments``. The winners are elected and the gradients summed over the
    global batch's occurrences (:func:`global_rows`), the ids made the
    shard's rows with every other id the sentinel ``V/E``
    (:func:`shard_local_ids`, a shard-local scratch of ``V/E + 1``), and
    only the shard's winners written back. ``frozen_spans`` are global
    rows."""
    advance = hp is None
    if mesh is not None:
        ids, g_rows = global_rows(mesh, ids, g_rows, segments)
    vocab, k = table.shape[0], ids.shape[0]
    if k == 0:
        if advance:
            opt_state["step"] = int(opt_state["step"]) + 1
        return table, opt_state
    if advance:
        step, hp = _own_row(opt_state, table.device, lr, b1, b2)
    gids = ids = ids.long()
    if mesh is not None:
        ids = shard_local_ids(ids, mesh.embed_index * vocab, vocab)
    occ = torch.arange(k, device=ids.device)
    winner = torch.zeros(vocab + (mesh is not None), dtype=torch.int32, device=ids.device)
    winner[ids] = occ.to(torch.int32)      # any duplicate wins
    rep = winner[ids].long()               # occurrence -> its winner
    # each winner's sum in the order of occurrence, whichever duplicate won:
    # an accumulating index_put_ sums duplicates in that order on the card
    # too (index_add_'s atomics would sum them in any order, and two runs
    # could differ in the last bit)
    g_slot = torch.zeros_like(g_rows).index_put_((rep,), g_rows, accumulate=True)
    uid = torch.where(rep == occ, ids, vocab)  # non-winners write nothing
    if frozen_spans:
        uid = torch.where(frozen_ids_mask(gids, frozen_spans), vocab, uid)
    _rows_adam_core(table, opt_state, g_slot, uid.clamp(0, vocab - 1), uid, hp,
                    weight_decay, b1, b2, eps)
    if advance:
        opt_state["step"] = step
    return table, opt_state


def sparse_adam_occurrence_init(table: torch.Tensor) -> Dict:
    """State of :func:`sparse_adam_occurrence_update`: the combined row store
    ``comb [V, 3·D]`` = ``[weights | mu | nu]`` per row, and a host step
    count. One gather ``comb[ids]`` then serves the forward (the weights) and
    the update (the moments), and one row scatter writes both back."""
    v, d = table.shape
    comb = torch.zeros(v, 3 * d, dtype=table.dtype, device=table.device)
    comb[:, :d] = table.detach()
    return {"comb": comb, "step": 0}


@functools.lru_cache(maxsize=8)
def _owner_rows(segments, device):
    """The JAX package's batching of :func:`_grouped_occurrence_segsum`:
    ``(order, back, shapes)``. The segments that share an owner are merged
    (in segment order), and the owners of equal merged length ``n`` are
    stacked into one ``[F, n]`` call, lengths and owners in order of first
    appearance. ``order`` (on ``device``) lists the occurrences in that
    stacked layout and ``back`` the position of each occurrence in it, both
    None when the layout is the ids' own order; ``shapes`` the ``(F, n)`` of
    each call."""
    pieces = {}
    for owner, start, size in segments:
        pieces.setdefault(owner, []).append((start, size))
    by_len = {}
    for owner_pieces in pieces.values():
        by_len.setdefault(sum(z for _, z in owner_pieces), []).append(owner_pieces)
    order = [i for owners in by_len.values() for owner_pieces in owners
             for s, z in owner_pieces for i in range(s, s + z)]
    shapes = tuple((len(owners), n) for n, owners in by_len.items())
    if order == list(range(len(order))):
        return None, None, shapes
    # made once (a train step's warm-up makes it before a CUDA graph capture),
    # outside inference mode
    with torch.inference_mode(False):
        order = torch.tensor(order, device=device)
        return order, torch.argsort(order), shapes


def _grouped_occurrence_segsum(g_rows, ids, segments):
    """For every occurrence, the sum of the gradients of all occurrences of
    its row id (``[K, D]``), batched as the JAX package does
    (``scenario_wise_rec_tpu/train/optim.py:_grouped_occurrence_segsum``):
    one ``occurrence_segsum`` launch per distinct owner length. At Ali-CCP
    (23 owners of 4096 ids, in order) that is one ``[23, 4096]`` call on a
    view of the ids and gradients, no copy; otherwise the occurrences are
    gathered into the stacked layout and the sums gathered back."""
    if sum(size for _, _, size in segments) != ids.shape[0]:
        raise ValueError("segments do not cover the ids")
    order, back, shapes = _owner_rows(tuple(segments), ids.device)
    if order is not None:
        ids, g_rows = ids[order], g_rows[order]
    d, sums, at = g_rows.shape[-1], [], 0
    for f, n in shapes:
        sums.append(occurrence_segsum(ids[at:at + f * n].view(f, n),
                                      g_rows[at:at + f * n].view(f, n, d)).view(f * n, d))
        at += f * n
    out = sums[0] if len(sums) == 1 else torch.cat(sums)
    return out if order is None else out[back]


def sparse_adam_occurrence_update(opt_state, g_rows, ids, segments, r3,
                                  lr: float = 1e-3, weight_decay: float = 1e-5,
                                  b1: float = 0.9, b2: float = 0.999,
                                  eps: float = 1e-8, frozen_spans: Spans = (),
                                  hp: Optional[torch.Tensor] = None, mesh=None):
    """Lazy Adam on the combined row store (the ``occurrence`` update), the
    semantics of :func:`sparse_adam_rowgrads_update`:

    1. duplicate gradients summed per occurrence (``occurrence_segsum``):
       every occurrence of an id carries the identical sum;
    2. Adam on the gathered rows ``r3 = comb[ids]`` (``[K, 3·D]``, the
       caller's forward already needed them);
    3. one row scatter of the updated ``[K, 3·D]`` rows back into comb
       (``scatter_rows``): duplicates write identical rows, and a frozen id
       writes back its old row.

    ``segments``: the ``(owner, start, size)`` layout of ``ids``
    (``EmbeddingCollection.touched_owner_segments``). Updates
    ``opt_state["comb"]`` in place and returns ``opt_state``; the weights
    are ``comb[:, :D]``.

    The step's ``lr``, ``1 - b1^t`` and ``1 - b2^t`` are read from a ``[3]``
    float32 row on the store's device (:func:`occurrence_hparams_rows`),
    and the update divides by the corrections there. ``hp``: that row, as
    the trainer's CUDA graphs replay this call with each step's row; ``lr``
    is then unused and ``opt_state["step"]`` is left to the caller. Without
    ``hp`` the update stages its step's row itself (on a card from pinned
    memory, no sync), so an eager step and a replay compute alike: PyTorch's
    CUDA division by a host number multiplies by its reciprocal, by a device
    number it divides.

    ``mesh`` (a ``parallel.Mesh``): ``comb`` is this rank's row shard and
    ``ids``/``g_rows`` this rank's batch rows, laid out as ``segments``;
    ``r3`` is unused (None). The duplicate sums run over the global
    batch's layout (:func:`global_rows`, :func:`global_segments`: at
    Ali-CCP still one ``[23, 4096]`` launch), Adam on every occurrence
    with the rows of ``comb`` at its shard-local id, and one
    ``scatter_rows`` writes back the occurrences that fall in the shard:
    every other id is the sentinel ``V/E`` (:func:`shard_local_ids`),
    which it drops. ``frozen_spans`` are global rows."""
    advance = hp is None
    comb = opt_state["comb"]
    if mesh is not None:
        ids, g_rows = global_rows(mesh, ids, g_rows, segments)
        segments = global_segments(mesh, segments)
    if ids.shape[0] == 0:
        if advance:
            opt_state["step"] = int(opt_state["step"]) + 1
        return opt_state
    if advance:
        step, hp = _own_row(opt_state, comb.device, lr, b1, b2)
    lr_t, bc1, bc2 = hp[0], hp[1], hp[2]
    d = g_rows.shape[-1]
    with torch.no_grad():
        dst = ids
        if mesh is not None:
            vl = comb.shape[0]
            dst = shard_local_ids(ids, mesh.embed_index * vl, vl)
            r3 = comb[dst.clamp(max=vl - 1)]
        g = _grouped_occurrence_segsum(g_rows, ids, segments)
        p = r3[:, :d]
        if weight_decay:
            g = g + weight_decay * p  # torch Adam: decay folded into the gradient
        mu = b1 * r3[:, d:2 * d] + (1 - b1) * g
        nu = b2 * r3[:, 2 * d:] + (1 - b2) * (g * g)
        update = lr_t * (mu / bc1) / (torch.sqrt(nu / bc2) + eps)
        new3 = torch.cat([p - update, mu, nu], dim=1)
        if frozen_spans:
            new3 = torch.where(frozen_ids_mask(ids, frozen_spans)[:, None], r3, new3)
        scatter_rows(comb, dst, new3)
    if advance:
        opt_state["step"] = step
    return opt_state


@functools.lru_cache(maxsize=64)
def _sizes_row(sizes: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The segments' sizes as a long row on ``device``, made once per layout
    (and outside inference mode): a step copies nothing from the host, so a
    CUDA graph can capture it."""
    with torch.inference_mode(False):
        return torch.tensor(sizes, dtype=torch.long, device=device)


def segment_sorted_ids(ids: torch.Tensor, segments):
    """``(sorted_ids int32, sorted_pos int32, sizes)``: ``ids`` sorted
    ascending within each ``(owner, start, size)`` segment (one stable sort
    of the key ``(segment, id)``, so duplicates keep their order of
    occurrence), the original position of each, and the segments' sizes."""
    sizes, pos = [], 0
    for _, start, size in segments:
        if start != pos:
            raise ValueError(f"segments must tile the ids in order; {start} != {pos}")
        sizes.append(int(size))
        pos += size
    if pos != ids.shape[0]:
        raise ValueError("segments do not cover the ids")
    seg = torch.repeat_interleave(torch.arange(len(sizes), device=ids.device),
                                  _sizes_row(tuple(sizes), ids.device), output_size=pos)
    key = (seg << 32) + (ids.long() + 2 ** 31)  # signed id order within a segment
    _, perm = torch.sort(key, stable=True)
    return ids[perm].to(torch.int32), perm.to(torch.int32), sizes


def fused_dense_adam_update(table, opt_state, g_rows, ids, segments,
                            lr: float = 1e-3, weight_decay: float = 1e-5,
                            b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                            block_rows: int = FUSED_BLOCK_ROWS,
                            frozen_spans: Spans = (),
                            hp: Optional[torch.Tensor] = None, mesh=None):
    """Exact dense torch-Adam on ``table`` (the ``dense`` update): every row
    takes weight decay and moment decay every step, as the reference's
    ``torch.optim.Adam`` over ``nn.Embedding.weight``. Each segment's ids
    are sorted separately (:func:`segment_sorted_ids`), which is all the
    kernel of ``ops/kernels/fused_adam.py`` needs; the gradient rows stay in
    their order. Frozen spans keep their rows and moments. In place; returns
    ``(table, opt_state)``.

    ``hp``: the step's 7 Adam numbers as a ``[7]`` float32 tensor on the
    table's device, as :func:`sorted_dense_adam_update` takes them; ``lr``
    to ``eps`` are then unused and ``opt_state["step"]`` is left to the
    caller.

    ``mesh`` (a ``parallel.Mesh``): ``table``, ``mu`` and ``nu`` are this
    rank's row shard and ``ids``/``g_rows`` this rank's batch rows, laid out
    as ``segments``. They are gathered over ``data`` into the global batch's
    layout (:func:`global_rows`), each global segment sorted, and the shard
    stepped by ``fused_dense_adam_apply_sharded``; ``frozen_spans`` are
    global rows, kept where they meet the shard (:func:`shard_spans`)."""
    step, advance = int(opt_state["step"]) + 1, hp is None
    if advance:
        hp = adam_hparams(step, lr, weight_decay, b1, b2, eps)
    apply = fused_dense_adam_apply
    if mesh is not None:
        ids, g_rows = global_rows(mesh, ids, g_rows, segments)
        segments = global_segments(mesh, segments)
        row0 = mesh.embed_index * table.shape[0]
        frozen_spans = shard_spans(frozen_spans, row0, table.shape[0])
        apply = functools.partial(fused_dense_adam_apply_sharded, row0=row0)
    sorted_ids, sorted_pos, sizes = segment_sorted_ids(ids, segments)
    tensors = (table.detach(), opt_state["mu"], opt_state["nu"])
    with rows_kept(tensors, frozen_spans):
        apply(*tensors, g_rows.contiguous(), sorted_ids, sorted_pos, sizes, hp,
              block_rows=block_rows)
    if advance:
        opt_state["step"] = step
    return table, opt_state


def sorted_dense_adam_update(table: torch.Tensor, opt_state: Dict,
                             g_rows: torch.Tensor, ids: torch.Tensor, *,
                             lr: float = 1e-3, weight_decay: float = 1e-5,
                             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                             block_rows: Optional[int] = None,
                             frozen_spans: Spans = (),
                             hp: Optional[torch.Tensor] = None,
                             mesh=None, segments=()) -> Dict:
    """One exact dense torch-Adam step of ``table`` (in place) from the
    per-occurrence gradient rows ``g_rows [K, D]`` of the packed rows
    ``ids [K]`` (``EmbeddingCollection.touched_ids``, duplicates allowed).
    For a bf16 store (:func:`sorted_dense_adam_init` with ``dtype``),
    ``table`` is the store's ``opt_state["table"]``: the kernel's bf16 form
    steps it, each value rounded back to bf16.

    Identical semantics to the reference's ``torch.optim.Adam`` over
    ``nn.Embedding.weight``: every row receives weight decay and moment
    decay every step. ``hp`` is computed on the host from the integer step
    count, so the step costs no device sync. Frozen spans keep their rows
    and moments. Updates ``opt_state`` in place and returns it. (The JAX
    function also takes the owner segments and offsets, which its per-owner
    sorts need; one global sort here does not.)

    ``hp``: the step's 7 Adam numbers as a ``[7]`` float32 tensor on the
    table's device (a row of ``adam_hparams_rows`` in
    ``ops/kernels/sorted_adam.py``), which the kernel reads there; ``lr`` to
    ``eps`` are then unused and ``opt_state["step"]`` is left to the caller,
    who advances it by the steps run (the trainer's CUDA graphs replay this
    call with each step's row).

    ``mesh`` (a ``parallel.Mesh``; the JAX function's ``mesh=``): ``table``,
    ``mu`` and ``nu`` are this rank's row shard (``parallel.shard_range``)
    and ``ids``/``g_rows`` this rank's batch rows, laid out as
    ``segments`` (``touched_owner_segments``) says. The ids and gradient
    rows are gathered over the ``data`` group and put in the global batch's
    layout (each segment's rows of every rank in turn: what the JAX
    package's replicated ids are), sorted, and the shard is stepped by
    ``sorted_dense_adam_apply_sharded``. ``frozen_spans`` are global rows.
    """
    step, advance = int(opt_state["step"]) + 1, hp is None
    if advance:
        hp = adam_hparams(step, lr, weight_decay, b1, b2, eps)
    tensors = (table.detach(), opt_state["mu"], opt_state["nu"])
    apply = sorted_dense_adam_apply
    if mesh is not None:
        ids, g_rows = global_rows(mesh, ids, g_rows, segments)
        row0 = mesh.embed_index * table.shape[0]
        frozen_spans = shard_spans(frozen_spans, row0, table.shape[0])
        apply = functools.partial(sorted_dense_adam_apply_sharded, row0=row0)
    sorted_ids, g_sorted = owner_sorted_grads(ids, g_rows)
    with rows_kept(tensors, frozen_spans):
        apply(*tensors, sorted_ids, g_sorted.contiguous(), hp, block_rows=block_rows)
    if advance:
        opt_state["step"] = step
    return opt_state


def global_rows(mesh, ids: torch.Tensor, g_rows: torch.Tensor, segments):
    """This rank's ``ids [K_l]`` and ``g_rows [K_l, D]`` (laid out as
    ``segments``, ``(owner, start, size)``) gathered over the mesh's ``data``
    group into the global batch's layout: each segment's rows of rank 0,
    rank 1, ... in turn, as ``touched_ids`` lays out the global batch."""
    n = mesh.shape["data"]
    if n == 1:
        return ids, g_rows
    k = ids.shape[0]
    order = torch.cat([(torch.arange(n, device=ids.device)[:, None] * k
                        + torch.arange(start, start + size, device=ids.device)).reshape(-1)
                       for _, start, size in segments])
    return (all_gather_rows(ids, mesh.data_group)[order],
            all_gather_rows(g_rows.contiguous(), mesh.data_group)[order])


def global_segments(mesh, segments):
    """The ``(owner, start, size)`` layout of :func:`global_rows`' output:
    segment ``s`` of every data rank in turn, ``n_data`` times its local
    size, in order (the global batch's ``touched_owner_segments``)."""
    n = mesh.shape["data"]
    return tuple((owner, n * start, n * size) for owner, start, size in segments)


def shard_local_ids(ids: torch.Tensor, row0: int, rows: int) -> torch.Tensor:
    """Whole-table ``ids`` as rows of the shard ``[row0, row0 + rows)``:
    ``id - row0`` inside it, the sentinel ``rows`` outside, which a gather
    clamps and ``scatter_rows`` drops. Never ``id - row0`` outside:
    ``scatter_rows`` wraps a negative id once (the reference's XLA
    semantics), so it would overwrite rows at the shard's tail."""
    local = ids.long() - int(row0)
    return torch.where((local >= 0) & (local < rows), local, rows)


def shard_spans(spans: Spans, row0: int, rows: int) -> Tuple[Tuple[int, int], ...]:
    """Global ``(offset, n)`` row spans intersected with the shard ``[row0,
    row0 + rows)``, in the shard's rows."""
    out = []
    for off, n in spans:
        lo, hi = max(off, row0), min(off + n, row0 + rows)
        if lo < hi:
            out.append((lo - row0, hi - lo))
    return tuple(out)
