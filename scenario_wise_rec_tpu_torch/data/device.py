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
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.config import resolve_device
from .dataset import ColumnarDataset


Layout = Dict[str, Tuple[str, int, int, tuple]]


def column_layout(x: Dict[str, np.ndarray]) -> Tuple[Layout, int, int]:
    """``(layout, n_int, n_float)`` of a batch or dataset's columns packed
    into an int matrix ``[N, n_int]`` and a float one ``[N, n_float]``
    (rows are examples), in the columns' order: ``layout[name] = (kind,
    start, width, tail)``, ``kind`` "int" for integer columns, ``width`` the
    columns a name takes (a ``[N, L]`` sequence column takes L), ``tail``
    its shape past the batch axis."""
    layout: Layout = {}
    n = {"int": 0, "float": 0}
    for name, col in x.items():
        col = np.asarray(col)
        tail = col.shape[1:]
        width = int(np.prod(tail)) if tail else 1
        kind = "int" if np.issubdtype(col.dtype, np.integer) else "float"
        layout[name] = (kind, n[kind], width, tail)
        n[kind] += width
    return layout, n["int"], n["float"]


def pack_columns(x: Dict[str, np.ndarray], layout: Layout, ints: np.ndarray,
                 floats: np.ndarray) -> None:
    """Write the columns of ``x`` into ``ints [N, n_int]`` (int32) and
    ``floats [N, >= n_float]`` (float32) at ``layout``'s places."""
    for name, (kind, start, width, _) in layout.items():
        col = np.asarray(x[name])
        dst = ints if kind == "int" else floats
        dst[:, start:start + width] = col.reshape(col.shape[0], width)


def gather_columns(layout: Layout, xi: torch.Tensor, xf: torch.Tensor):
    """Reassemble the model's ``(x_dict, y)`` from packed rows ``xi [B,
    n_int]`` and ``xf [B, n_float + 1]``, the label the last float column.

    One copy each makes every column a contiguous row of a ``[C, B]``
    matrix (the fused kernels' wrappers take contiguous ids) and widens the
    ids to int64, the dtype of the host path's numpy columns, so a packed
    batch feeds the step exactly what a host batch does."""
    b = xi.shape[0]
    cols = {"int": xi.t().to(torch.int64, memory_format=torch.contiguous_format),
            "float": xf.t().contiguous()}
    x = {}
    for name, (kind, start, width, tail) in layout.items():
        block = cols[kind][start:start + width]
        x[name] = block.t().reshape((b,) + tail).contiguous() if tail else block[0]
    return x, cols["float"][-1]


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

        # layout: name -> (kind, start, n_cols, tail_shape)
        self.layout, n_int, n_float = column_layout(dataset.x)
        if dataset.y is None:
            raise ValueError("resident training needs labels")
        ints = np.empty((self.n, n_int), np.int32)
        floats = np.empty((self.n, n_float + 1), np.float32)
        pack_columns(dataset.x, self.layout, ints, floats)
        floats[:, n_float] = np.asarray(dataset.y, np.float32)
        self.int_mat = torch.from_numpy(ints).to(self.device)
        self.float_mat = torch.from_numpy(floats).to(self.device)

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
        ``xi = int_mat[ids]``, ``xf = float_mat[ids]`` (:func:`gather_columns`
        over the loader's layout). ``ids`` is unused (kept for the JAX call
        signature)."""
        del ids
        return gather_columns(self.layout, xi, xf)
