"""Feature schema: declarative description of model inputs.

The same config objects as the JAX package's ``core/features.py``. Features
carry *no* parameters; tables are created by
:class:`scenario_wise_rec_tpu_torch.ops.embedding.EmbeddingCollection`.
"""

from __future__ import annotations

import math
from typing import Optional

from . import init as initializers


def get_auto_embedding_dim(num_classes: int) -> int:
    """Auto embedding dim rule: ``floor(6 * num_classes ** 0.26)``.

    Matches the reference *code*, whose docstring says ``n ** 0.25`` but
    whose implementation uses ``0.26``; we follow the code.
    """
    return int(math.floor(6 * num_classes ** 0.26))


class Feature:
    """Base class for feature specs (identity-hashable static config)."""

    name: str
    embed_dim: int

    def __repr__(self):  # pragma: no cover - cosmetic
        return f"<{type(self).__name__} {self.name}>"


class DenseFeature(Feature):
    """A scalar (already numeric) feature. ``embed_dim`` is fixed to 1."""

    def __init__(self, name: str):
        self.name = name
        self.embed_dim = 1


class SparseFeature(Feature):
    """A categorical feature backed by an embedding table.

    Args:
        name: column name in the batch dict.
        vocab_size: number of rows of the embedding table.
        embed_dim: embedding width (auto-sized if None).
        shared_with: name of another feature whose table this one re-uses.
        padding_idx: entries equal to this id are masked to 0 by input masks.
        initializer: ``(generator, shape) -> tensor`` initializer for the
            table (default: normal(0, 1e-4)).
    """

    def __init__(
        self,
        name: str,
        vocab_size: int,
        embed_dim: Optional[int] = None,
        shared_with: Optional[str] = None,
        padding_idx: Optional[int] = None,
        initializer=None,
    ):
        self.name = name
        self.vocab_size = int(vocab_size)
        self.embed_dim = (
            get_auto_embedding_dim(vocab_size) if embed_dim is None else int(embed_dim)
        )
        self.shared_with = shared_with
        self.padding_idx = padding_idx
        self.initializer = initializer or initializers.random_normal(0.0, 1e-4)


class SequenceFeature(Feature):
    """A padded id-sequence / multi-hot feature, pooled to one vector.

    Args:
        pooling: one of ``{"mean", "sum", "concat"}`` (default "mean").
        (other args as :class:`SparseFeature`)
    """

    def __init__(
        self,
        name: str,
        vocab_size: int,
        embed_dim: Optional[int] = None,
        pooling: str = "mean",
        shared_with: Optional[str] = None,
        padding_idx: Optional[int] = None,
        initializer=None,
    ):
        if pooling not in ("mean", "sum", "concat"):
            raise ValueError(
                f"pooling must be one of ['mean', 'sum', 'concat'], got {pooling}"
            )
        self.name = name
        self.vocab_size = int(vocab_size)
        self.embed_dim = (
            get_auto_embedding_dim(vocab_size) if embed_dim is None else int(embed_dim)
        )
        self.pooling = pooling
        self.shared_with = shared_with
        self.padding_idx = padding_idx
        self.initializer = initializer or initializers.random_normal(0.0, 1e-4)


def sum_embed_dims(features) -> int:
    """Total flattened embedding width of a feature list."""
    return sum(f.embed_dim for f in features)
