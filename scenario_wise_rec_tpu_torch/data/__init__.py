from .dataset import (
    BatchIterable,
    ColumnarDataset,
    DataGenerator,
    PredictIterable,
)
from .device import DeviceResidentLoader
from .prefetch import Prefetcher, prefetch, stage_batches

__all__ = [
    "BatchIterable",
    "ColumnarDataset",
    "DataGenerator",
    "DeviceResidentLoader",
    "PredictIterable",
    "Prefetcher",
    "prefetch",
    "stage_batches",
]
