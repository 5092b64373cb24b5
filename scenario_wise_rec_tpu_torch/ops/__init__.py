from .embedding import EmbeddingCollection, clamp_rows, input_mask
from .nn import BN_EPS, MLP, BatchNorm, Linear, batch_stats, batchnorm, linear
from .select import domain_select

__all__ = [
    "EmbeddingCollection",
    "clamp_rows",
    "input_mask",
    "BN_EPS",
    "MLP",
    "BatchNorm",
    "Linear",
    "batch_stats",
    "batchnorm",
    "linear",
    "domain_select",
]
