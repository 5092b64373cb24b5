from .embedding import EmbeddingCollection, clamp_rows, input_mask
from .nn import (BN_EPS, MLP, BatchNorm, LayerNorm, Linear, batch_stats, batchnorm, layernorm,
                 linear)
from .select import domain_select
from .transformer import Transformer

__all__ = [
    "EmbeddingCollection",
    "clamp_rows",
    "input_mask",
    "BN_EPS",
    "MLP",
    "BatchNorm",
    "LayerNorm",
    "Linear",
    "batch_stats",
    "batchnorm",
    "layernorm",
    "linear",
    "domain_select",
    "Transformer",
]
