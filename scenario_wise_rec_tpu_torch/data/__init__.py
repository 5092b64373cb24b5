from .dataset import (
    BatchIterable,
    ColumnarDataset,
    DataGenerator,
    PredictIterable,
)
from .prefetch import Prefetcher, prefetch

__all__ = [
    "BatchIterable",
    "ColumnarDataset",
    "DataGenerator",
    "PredictIterable",
    "Prefetcher",
    "prefetch",
]
