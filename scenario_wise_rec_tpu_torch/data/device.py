"""Device-resident epochs: batch assembly on the card, not the host.

The port's copy of the JAX package's ``data/device.py``. The host pipeline
(``BatchIterable`` -> prefetch thread -> one copy per column) pays a host
slice and a copy per column every batch. Here the epoch's columns go to the
device ONCE as two packed matrices (ints ``[N, Ci]``, floats ``[N, Cf]``),
and each train step gathers its batch on the device from a slice of the
epoch's permutation (``CTRTrainer.train_one_epoch_resident``): the host's
per-epoch work is one RNG permutation and one copy of its ids.

Batch semantics are IDENTICAL to ``BatchIterable`` with the same seed: the
same per-epoch permutation stream and the same padding of the final partial
batch (its first row repeated, weight 0), so the trained state is the host
path's (``tests/test_torch_port_resident.py``).
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Tuple

import numpy as np
import torch

from ..core.config import resolve_device
from .dataset import ColumnarDataset


class DeviceResidentLoader:
    """Epoch source for :meth:`CTRTrainer.train_one_epoch_resident`.

    Mirrors ``BatchIterable(dataset, batch_size, shuffle=True, seed)``: one
    call to :meth:`epoch_perm` per epoch advances the same shuffle stream.
    Integer columns (ids, domain indicator, sequence features flattened)
    pack into ``int_mat`` (int32, as the JAX loader's); float columns into
    ``float_mat`` with the label as the LAST float column, so a batch is two
    row gathers on the device.

    ``device``: where the matrices live, default ``"cuda"``; with no card
    present this raises unless the caller passes ``"cpu"``. The trainer
    takes a loader on its own device only.
    """

    def __init__(self, dataset: ColumnarDataset, batch_size: int,
                 seed: int = 0, shuffle: bool = True,
                 device_shuffle: bool = False, device="cuda"):
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        # device_shuffle=True: the trainer draws each epoch's permutation on
        # the device (torch.randperm from a generator seeded by
        # epoch_seed()): no host RNG pass and no permutation copy per epoch.
        # Its stream differs from BatchIterable's numpy stream (equally
        # uniform); keep the default for bit-parity with the host pipeline.
        self.device_shuffle = bool(device_shuffle)
        self.device = resolve_device(device)
        self._rng = np.random.default_rng(seed)
        self.n = len(dataset)
        self._next_perm = None
        self._perm_pool = None

        int_cols: List[np.ndarray] = []
        float_cols: List[np.ndarray] = []
        # layout: name -> (kind, start, n_cols, tail_shape)
        self.layout: Dict[str, Tuple[str, int, int, tuple]] = {}
        for name, col in dataset.x.items():
            tail = col.shape[1:]
            width = int(np.prod(tail)) if tail else 1
            flat = col.reshape(self.n, width)
            if np.issubdtype(col.dtype, np.integer):
                self.layout[name] = ("int", len(int_cols), width, tail)
                int_cols.extend(flat.astype(np.int32).T)
            else:
                self.layout[name] = ("float", len(float_cols), width, tail)
                float_cols.extend(flat.astype(np.float32).T)
        if dataset.y is None:
            raise ValueError("resident training needs labels")
        float_cols.append(np.asarray(dataset.y, np.float32))

        ints = (np.stack(int_cols, axis=1) if int_cols
                else np.zeros((self.n, 0), np.int32))
        self.int_mat = torch.from_numpy(ints).to(self.device)
        self.float_mat = torch.from_numpy(np.stack(float_cols, axis=1)).to(self.device)

    def __len__(self) -> int:
        """Batches per epoch (BatchIterable semantics, no drop_last)."""
        return (self.n + self.batch_size - 1) // self.batch_size

    def nbytes(self) -> int:
        """Bytes the two matrices hold on the device."""
        return sum(t.numel() * t.element_size() for t in (self.int_mat, self.float_mat))

    def _compute_perm(self) -> Tuple[np.ndarray, np.ndarray]:
        bs = self.batch_size
        idx = (self._rng.permutation(self.n) if self.shuffle
               else np.arange(self.n))
        rem = self.n % bs
        w = np.ones(len(self) * bs, np.float32)
        if rem:
            pad = bs - rem
            idx = np.concatenate(
                [idx, np.repeat(idx[self.n - rem: self.n - rem + 1], pad)])
            w[-pad:] = 0.0
        return idx.astype(np.int32), w

    def epoch_perm(self) -> Tuple[np.ndarray, np.ndarray]:
        """Next epoch's ``(row_ids [Nb*B] int32, weights [Nb*B])``.

        Same permutation stream as BatchIterable(shuffle=True) with this
        seed; the final partial batch repeats its own first row with weight
        0, exactly like BatchIterable._make. The FOLLOWING epoch's
        permutation starts computing on a worker thread at once (an O(N)
        host RNG pass that would otherwise sit on the epoch boundary); the
        single worker keeps the RNG call order, so the stream is unchanged.
        """
        if self._perm_pool is None:
            self._perm_pool = ThreadPoolExecutor(max_workers=1)
        out = (self._next_perm.result() if self._next_perm is not None
               else self._compute_perm())
        self._next_perm = self._perm_pool.submit(self._compute_perm)
        return out

    def epoch_seed(self) -> int:
        """Per-epoch seed for the device-side shuffle (``device_shuffle``):
        one draw from the same generator, so epochs get independent
        permutations and runs are reproducible given the loader seed."""
        return int(self._rng.integers(0, 2**31 - 1))

    def close(self) -> None:
        """Release the permutation worker and the speculative next-epoch
        permutation it holds."""
        if self._perm_pool is not None:
            self._perm_pool.shutdown(wait=False, cancel_futures=True)
            self._perm_pool = None
        self._next_perm = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    def gather_batch(self, xi: torch.Tensor, xf: torch.Tensor, ids=None):
        """Reassemble the model's ``(x_dict, y)`` from gathered rows
        ``xi = int_mat[ids]``, ``xf = float_mat[ids]``. ``ids`` is unused
        (kept for the JAX call signature).

        One copy each makes every column a contiguous row of a ``[C, B]``
        matrix (the fused kernels' wrappers take contiguous ids) and widens
        the ids to int64, the dtype of the host path's numpy columns, so a
        resident batch feeds the step exactly what a host batch does."""
        del ids
        b = xi.shape[0]
        cols = {"int": xi.t().to(torch.int64, memory_format=torch.contiguous_format),
                "float": xf.t().contiguous()}
        x = {}
        for name, (kind, start, width, tail) in self.layout.items():
            block = cols[kind][start:start + width]
            x[name] = block.t().reshape((b,) + tail).contiguous() if tail else block[0]
        return x, cols["float"][-1]
