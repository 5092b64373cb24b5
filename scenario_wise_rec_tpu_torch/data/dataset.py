"""Columnar data pipeline.

The port's copy of the JAX package's numpy-only ``data/dataset.py``. It
replaces the reference's row-wise torch DataLoader (utils/data.py:11-62),
whose per-row dict ``__getitem__`` is its real throughput bottleneck. Here a
dataset is a dict of contiguous numpy columns; batching is pure slicing of a
shuffled index permutation, and the last partial batch is **padded to the
fixed batch size** with a 0/1 weight mask so every batch has the same shape
(the fused kernels and, later, CUDA graphs see one shape).

``DataGenerator.generate_dataloader`` keeps the reference's exact split
semantics: either ``split_ratio`` random splits (utils/data.py:47-53) or
explicit val/test sets (:54-57); train shuffled each epoch, val/test not.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

import numpy as np

WEIGHT_KEY = "__weight__"


def _to_columns(x, y=None):
    """Accept pandas DataFrame/Series or dict-of-arrays; return numpy dict."""
    if hasattr(x, "to_dict") and hasattr(x, "columns"):  # DataFrame
        cols = {c: np.asarray(x[c].values) for c in x.columns}
    else:
        cols = {k: np.asarray(v) for k, v in x.items()}
    yv = None if y is None else np.asarray(getattr(y, "values", y))
    return cols, yv


class ColumnarDataset:
    """dict-of-columns dataset (reference TorchDataset, utils/data.py:11-22)."""

    def __init__(self, x, y=None):
        self.x, self.y = _to_columns(x, y)
        lengths = {len(v) for v in self.x.values()}
        assert len(lengths) == 1, "all columns must share a length"
        self.length = lengths.pop()
        if self.y is not None:
            assert len(self.y) == self.length

    def __len__(self):
        return self.length

    def select(self, idx: np.ndarray) -> "ColumnarDataset":
        return ColumnarDataset(
            {k: v[idx] for k, v in self.x.items()},
            None if self.y is None else self.y[idx],
        )


class BatchIterable:
    """Iterates fixed-size padded batches ``(x_dict, y, weights)``.

    - shuffle: new permutation per epoch from a seeded Generator
    - pad: final partial batch is padded by repeating row 0; ``weights`` is 0
      on padded rows, so losses/metrics are exact while shapes stay static.
    - drop_last: optionally drop the partial batch (train-time option).
    """

    def __init__(self, dataset: ColumnarDataset, batch_size: int,
                 shuffle: bool = False, seed: int = 0, drop_last: bool = False):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self._rng = np.random.default_rng(seed)
        self._epoch = 0

    def __len__(self):
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Tuple[Dict[str, np.ndarray], Optional[np.ndarray], np.ndarray]]:
        n = len(self.dataset)
        bs = self.batch_size
        idx = self._rng.permutation(n) if self.shuffle else np.arange(n)
        self._epoch += 1
        n_full = n // bs
        for b in range(n_full):
            sel = idx[b * bs : (b + 1) * bs]
            yield self._make(sel, bs, pad=0)
        rem = n - n_full * bs
        if rem and not self.drop_last:
            sel = idx[n_full * bs :]
            yield self._make(sel, bs, pad=bs - rem)

    def _make(self, sel, bs, pad):
        if pad:
            sel = np.concatenate([sel, np.repeat(sel[:1], pad)])
        xb = {k: v[sel] for k, v in self.dataset.x.items()}
        yb = None if self.dataset.y is None else self.dataset.y[sel]
        w = np.ones(bs, np.float32)
        if pad:
            w[bs - pad :] = 0.0
        return xb, yb, w


class DataGenerator:
    """Split + loader factory (reference utils/data.py:38-62)."""

    def __init__(self, x, y):
        self.dataset = ColumnarDataset(x, y)
        self.length = len(self.dataset)

    def generate_dataloader(self, x_val=None, y_val=None, x_test=None, y_test=None,
                            split_ratio=None, batch_size: int = 16,
                            num_workers: int = 8, seed: int = 0):
        """Return (train, val, test) BatchIterables.

        ``num_workers`` accepted for API parity; the columnar pipeline needs
        no worker processes.
        """
        if split_ratio is not None:
            train_length = int(self.length * split_ratio[0])
            val_length = int(self.length * split_ratio[1])
            test_length = self.length - train_length - val_length
            print(
                "the samples of train : val : test are  %d : %d : %d"
                % (train_length, val_length, test_length)
            )
            perm = np.random.default_rng(seed).permutation(self.length)
            train_ds = self.dataset.select(perm[:train_length])
            val_ds = self.dataset.select(perm[train_length : train_length + val_length])
            test_ds = self.dataset.select(perm[train_length + val_length :])
        else:
            train_ds = self.dataset
            val_ds = ColumnarDataset(x_val, y_val)
            test_ds = ColumnarDataset(x_test, y_test)

        train = BatchIterable(train_ds, batch_size, shuffle=True, seed=seed)
        val = BatchIterable(val_ds, batch_size, shuffle=False)
        test = BatchIterable(test_ds, batch_size, shuffle=False)
        return train, val, test


class PredictIterable(BatchIterable):
    """Unlabeled batches (reference PredictDataset, utils/data.py:25-35)."""

    def __init__(self, x, batch_size: int):
        super().__init__(ColumnarDataset(x, None), batch_size, shuffle=False)
