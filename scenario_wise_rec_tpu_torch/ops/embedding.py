"""Embedding engine: packed multi-table lookup with pooling and masking.

The forward of the JAX package's ``ops/embedding.py:EmbeddingCollection``:

- All owned tables that share the majority embed_dim are **packed into one
  mega-table** ``[sum(vocab_sizes), D]`` with per-owner row offsets, so a
  batch of F sparse features is a *single* gather ``packed[ids + offsets]``.
  Tables of another width stay loose (``tables``).
- ``shared_with`` aliasing resolves to the owner's table and offset.
- Sequence features gather ``[B, L, D]`` and are pooled (sum / mean /
  concat) under the padding mask.
- ``squeeze_dim=True`` -> ``[B, sum_sparse_dims (+ n_dense)]`` with ALL
  sparse blocks in feature-list order followed by the dense columns, even
  when dense features are listed first; ``squeeze_dim=False`` ->
  ``[B, F, D]`` (sparse/sequence only).

Out-of-range ids follow JAX indexing on the table they address, after the
owner's offset is added (:func:`clamp_rows`). ``F.embedding`` would raise on
them instead.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.features import DenseFeature, Feature, SequenceFeature, SparseFeature


def clamp_rows(rows: torch.Tensor, n_rows: int) -> torch.Tensor:
    """JAX ``table[rows]`` index rule: a negative index wraps once
    (``+ n_rows``), then the result is clamped to ``[0, n_rows - 1]``.
    So an id >= vocab in a middle feature of the packed table reads the next
    feature's rows, and ``arange(10)[[-1, 12, 3, -11, -30]]`` is
    ``[9, 9, 3, 0, 0]``."""
    rows = torch.where(rows < 0, rows + n_rows, rows)
    return rows.clamp(0, n_rows - 1)


def input_mask(x: Dict[str, torch.Tensor], feature) -> torch.Tensor:
    """Padding mask for one sparse/sequence feature: ids equal to
    ``padding_idx`` (or -1 when unset) are masked out. Float, ids' shape."""
    if not isinstance(feature, (SparseFeature, SequenceFeature)):
        raise ValueError("Only SparseFeature or SequenceFeature support to get mask.")
    pad = feature.padding_idx if feature.padding_idx is not None else -1
    return (_ids(x, feature) != pad).float()


def _ids(x: Dict[str, torch.Tensor], feature) -> torch.Tensor:
    # the JAX package casts ids to int32; indices are int64 in torch
    return x[feature.name].to(torch.int32).long()


def _pool(emb: torch.Tensor, mask: torch.Tensor, pooling: str) -> torch.Tensor:
    """Pool ``[B, L, D]`` under the ``[B, L]`` mask."""
    if pooling == "concat":
        # flattened so it concatenates with [B, D] features in squeeze mode
        return emb.reshape(emb.shape[0], -1)
    masked_sum = torch.einsum("bl,bld->bd", mask, emb)
    if pooling == "sum":
        return masked_sum
    # mean: masked sum / #non-padding (+1e-16)
    count = torch.sum(mask, dim=1, keepdim=True)
    return masked_sum / (count + 1e-16)


class EmbeddingCollection(nn.Module):
    """Owns the embedding tables for a feature list and performs lookups.

    Parameters: ``packed`` ``[V_total, D]`` for the packed group and
    ``tables[name]`` for odd-width tables, drawn from ``generator`` on its
    device, one table after another in owner order. ``frozen_spans`` and
    ``frozen_loose`` name the frozen pretrained tables (the JAX collection's
    rule), which the trainer keeps fixed.
    """

    def __init__(self, features: Sequence[Feature], generator: torch.Generator):
        super().__init__()
        self.features = tuple(features)
        # the plain gather's per-feature row offsets, built once per device: a
        # copy from host memory per forward would refuse a CUDA graph capture
        self._offset_rows: Dict[Tuple, torch.Tensor] = {}
        # Owned tables: first occurrence wins, aliases excluded
        owned: Dict[str, Feature] = {}
        for f in self.features:
            if isinstance(f, (SparseFeature, SequenceFeature)):
                if f.shared_with is None and f.name not in owned:
                    owned[f.name] = f
        self.owned = owned

        # Pack every owned table with the majority embed_dim into one table.
        dims = [f.embed_dim for f in owned.values()]
        self.packed_dim = max(set(dims), key=dims.count) if dims else 0
        self.offsets: Dict[str, int] = {}
        self.packed_names: List[str] = []
        total = 0
        for name, f in owned.items():
            if f.embed_dim == self.packed_dim:
                self.offsets[name] = total
                total += f.vocab_size
                self.packed_names.append(name)
        self.packed_vocab = total
        self.loose_names = [n for n in owned if n not in self.offsets]
        # frozen pretrained tables (an initializer with freeze=True,
        # core/init.py:pretrained): packed (offset, vocab) spans and loose
        # table names, which the trainer keeps fixed (train/freeze.py)
        frozen = lambda n: getattr(owned[n].initializer, "freeze", False)
        self.frozen_spans: Tuple[Tuple[int, int], ...] = tuple(
            (self.offsets[n], owned[n].vocab_size) for n in self.packed_names if frozen(n))
        self.frozen_loose: Tuple[str, ...] = tuple(n for n in self.loose_names if frozen(n))

        device = self._init_device = generator.device
        packed = (torch.empty((total, self.packed_dim), device=device)
                  if self.packed_names else None)
        tables = {}
        with torch.no_grad():
            for name, f in owned.items():
                t = f.initializer(generator, (f.vocab_size, f.embed_dim))
                if name in self.offsets:
                    off = self.offsets[name]
                    packed[off:off + f.vocab_size].copy_(t)
                else:
                    tables[name] = nn.Parameter(t.to(device))
        self.packed = nn.Parameter(packed) if packed is not None else None
        self.tables = nn.ParameterDict(tables) if tables else None

    def _owner(self, f) -> str:
        return f.shared_with if getattr(f, "shared_with", None) else f.name

    def _rows(self, owner: str, ids: torch.Tensor) -> torch.Tensor:
        if owner in self.offsets:
            rows = clamp_rows(ids + self.offsets[owner], self.packed_vocab)
            return self.packed[rows]
        table = self.tables[owner]
        return table[clamp_rows(ids, table.shape[0])]

    def touched_ids(self, x: Dict[str, torch.Tensor],
                    features: Sequence[Feature] | None = None) -> torch.Tensor:
        """Packed-table row indices touched by this batch (static shape).

        Union over every packed sparse/sequence feature (aliases resolve to
        the owner's offset), each feature's ids flattened row-major, in
        feature order. Out-of-range ids are clipped to the owner's own span
        here (``clip(ids, 0, vocab - 1) + offset``); the sorted embedding
        update relies on this.
        """
        parts: List[torch.Tensor] = []
        for f in self._packed_features(features):
            owner = self._owner(f)
            ids = _ids(x, f).reshape(-1)
            vocab = self.owned[owner].vocab_size
            parts.append(ids.clamp(0, vocab - 1) + self.offsets[owner])
        if not parts:
            # on the collection's device (where its tables live now)
            p = next(self.parameters(), None)
            device = p.device if p is not None else self._init_device
            return torch.zeros((0,), dtype=torch.long, device=device)
        return torch.cat(parts)

    def _packed_features(self, features=None) -> List[Feature]:
        """The sparse/sequence features whose owner is in the packed table,
        in order: the layout of :meth:`touched_ids`."""
        feats = self.features if features is None else tuple(features)
        return [f for f in feats
                if isinstance(f, (SparseFeature, SequenceFeature))
                and self._owner(f) in self.offsets]

    def _packed_layout(self, x: Dict[str, torch.Tensor]) -> List[Tuple[Feature, int, int]]:
        """``(feature, start, size)`` of each packed feature's ids in the
        canonical :meth:`touched_ids` order (``self.features`` order, each
        feature's ids flattened row-major): the contract between
        ``touched_ids`` and the ``rows`` cache :meth:`forward` slices."""
        layout, pos = [], 0
        for f in self._packed_features():
            size = x[f.name].numel()
            layout.append((f, pos, size))
            pos += size
        return layout

    def touched_owner_segments(
            self, x: Dict[str, torch.Tensor]) -> Tuple[Tuple[str, int, int], ...]:
        """Static ``(owner, start, size)`` layout of :meth:`touched_ids`.

        One entry per packed sparse/sequence feature, in concatenation
        order. Segments sharing an ``owner`` draw ids from the same packed
        span (``shared_with`` aliases), so a row id can recur across them.
        Python ints only (shapes), so reading it costs no device sync.
        """
        return tuple((self._owner(f), start, size)
                     for f, start, size in self._packed_layout(x))

    def _offset_row(self, offsets: Tuple[int, ...]) -> torch.Tensor:
        """``offsets`` as a long tensor on the table's device, made once (and
        outside inference mode, so that a train step may use one an eval pass
        made)."""
        key = (offsets, self.packed.device)
        row = self._offset_rows.get(key)
        if row is None:
            with torch.inference_mode(False):
                row = torch.tensor(offsets, dtype=torch.long, device=self.packed.device)
            self._offset_rows[key] = row
        return row

    def forward(self, x: Dict[str, torch.Tensor], features: Sequence[Feature],
                squeeze_dim: bool = False,
                rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Embed ``features`` from batch ``x``.

        ``rows``: optional pre-gathered packed rows ``packed[touched_ids(x)]``
        (``[K, D]``). Packed lookups then slice this cache instead of
        gathering the table, so the trainer's sorted mode can differentiate
        with respect to the rows: the embedding gradient is ``[K, D]``, never
        a dense ``[V, D]``.
        """
        features = list(features)
        layout = ({f.name: (start, size) for f, start, size in self._packed_layout(x)}
                  if rows is not None else None)
        # all packed plain-sparse features in ONE gather
        plain = [f for f in features
                 if isinstance(f, SparseFeature) and self._owner(f) in self.offsets]
        packed_cols: Dict[str, torch.Tensor] = {}
        if plain and rows is not None:
            for f in plain:
                start, size = layout[f.name]
                packed_cols[f.name] = rows[start:start + size]
        elif plain:
            off = self._offset_row(tuple(self.offsets[self._owner(f)] for f in plain))
            ids = torch.stack([_ids(x, f) for f in plain], dim=1) + off
            gathered = self.packed[clamp_rows(ids, self.packed_vocab)]  # [B, F, D]
            for i, f in enumerate(plain):
                packed_cols[f.name] = gathered[:, i, :]

        sparse_out: List[torch.Tensor] = []
        dense_out: List[torch.Tensor] = []
        for f in features:
            if isinstance(f, SparseFeature):
                if f.name in packed_cols:
                    sparse_out.append(packed_cols[f.name])
                else:
                    sparse_out.append(self._rows(self._owner(f), _ids(x, f)))
            elif isinstance(f, SequenceFeature):
                if rows is not None and self._owner(f) in self.offsets:
                    start, size = layout[f.name]
                    emb = rows[start:start + size].reshape(
                        tuple(x[f.name].shape) + (rows.shape[-1],))
                else:
                    emb = self._rows(self._owner(f), _ids(x, f))  # [B, L, D]
                sparse_out.append(_pool(emb, input_mask(x, f), f.pooling))
            elif isinstance(f, DenseFeature):
                dense_out.append(x[f.name].float().reshape(-1, 1))
            else:
                raise ValueError(f"unknown feature type: {f!r}")

        if squeeze_dim:
            parts = sparse_out + dense_out
            if not parts:
                raise ValueError("The input features can not be empty")
            return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)

        if not sparse_out:
            raise ValueError(
                "If keeping [B, F, D] shape, expected SparseFeatures in the list"
            )
        return torch.stack(sparse_out, dim=1)  # [B, F, D]
