from .features import (
    DenseFeature,
    SequenceFeature,
    SparseFeature,
    get_auto_embedding_dim,
    sum_embed_dims,
)
from .activations import activation
from . import init

__all__ = [
    "DenseFeature",
    "SequenceFeature",
    "SparseFeature",
    "get_auto_embedding_dim",
    "sum_embed_dims",
    "activation",
    "init",
]
