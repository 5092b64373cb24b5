"""Frozen pretrained embeddings (the JAX package's ``train/freeze.py``).

The reference freezes a table with ``nn.Embedding.from_pretrained(...,
freeze=True)`` (basic/initializers.py:76-92): the weight gets
``requires_grad=False`` and ``torch.optim.Adam`` skips it, so it takes no
update, no weight decay and keeps no moments. Which rows are frozen is
static, from the feature list of the model's ``embedding`` collection
(``EmbeddingCollection.frozen_spans`` and ``frozen_loose``). The trainer
keeps them fixed in every mode:

- a frozen loose table is set to ``requires_grad=False`` and never enters
  an optimizer;
- plain step (``torch.optim.Adam`` over the packed table): the frozen rows
  go back to their old values after the step (:func:`rows_kept`) and their
  ``exp_avg``/``exp_avg_sq`` rows to zero (:func:`zero_rows`), as the JAX
  package's ``freeze_updates`` zeroes both updates and moments;
- ``winner`` / ``occurrence``: frozen ids are dropped from the row
  write-back, or written back as their old row (:func:`frozen_ids_mask`);
- ``dense`` / ``sorted``: the in-place kernel runs, then the frozen spans
  of table, ``mu`` and ``nu`` are restored (:func:`rows_kept`): a copy of
  the frozen rows only, not a blend over all V.

The JAX package's packed-tile mask (``frozen_packed_mask``) is TPU layout
and has no counterpart here.
"""

from __future__ import annotations

import contextlib
from typing import Sequence, Tuple

import torch

Spans = Sequence[Tuple[int, int]]


def frozen_ids_mask(ids: torch.Tensor, spans: Spans) -> torch.Tensor:
    """Bool mask over packed row ``ids``: True where the id is frozen."""
    m = torch.zeros(ids.shape, dtype=torch.bool, device=ids.device)
    for off, n in spans:
        m |= (ids >= off) & (ids < off + n)
    return m


def frozen_rows_mask(v: int, spans: Spans, device=None) -> torch.Tensor:
    """Bool column ``[v, 1]``: True on frozen packed-table rows."""
    return frozen_ids_mask(torch.arange(v, device=device)[:, None], spans)


@contextlib.contextmanager
def rows_kept(tensors: Sequence[torch.Tensor], spans: Spans):
    """Whatever the body does to ``tensors`` (each ``[V, ...]``), their rows
    in ``spans`` leave it as they entered. Copies only those rows."""
    saved = [[t[off:off + n].detach().clone() for off, n in spans] for t in tensors]
    yield
    with torch.no_grad():
        for t, rows in zip(tensors, saved):
            for (off, n), r in zip(spans, rows):
                t[off:off + n] = r


def zero_rows(tensors: Sequence[torch.Tensor], spans: Spans) -> None:
    """Zero the rows in ``spans`` of each ``[V, ...]`` tensor, in place."""
    with torch.no_grad():
        for t in tensors:
            for off, n in spans:
                t[off:off + n] = 0
