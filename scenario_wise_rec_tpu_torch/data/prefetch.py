"""Background-thread batch prefetch.

The port's copy of the JAX package's ``data/prefetch.py``. The reference
overlaps host batch assembly with device compute via DataLoader worker
processes (reference utils/data.py:59-61, num_workers=8). The columnar
pipeline's per-batch host work is tiny (pure numpy slicing) but not free:
at device step times of well under a millisecond the host-side slice sits
on the critical path between launches. A single daemon thread with a
bounded queue hides it behind device execution; no worker processes, no
serialization.

:func:`stage_batches` adds the port's own step on that thread: on a CUDA
trainer each batch's columns are staged in pinned host memory, so that the
trainer's copies to the card (``non_blocking=True``) neither sync the
stream nor block the host, as the JAX package's ``jnp.asarray`` does not.
:func:`stage_dispatches` does the same for a dispatch of S batches
(``CTRTrainer(scan_steps=S)``), packed as ``DeviceResidentLoader`` packs an
epoch: one int matrix and one float matrix, the JAX package's
``_scan_producer`` stacking ``[S, B]`` on the same thread.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, NamedTuple

import numpy as np
import torch

from .device import column_layout, pack_columns


class Prefetcher:
    """Iterate ``iterable`` on a daemon thread, ``depth`` items ahead.

    Preserves order and exceptions: an exception raised by the producer is
    re-raised in the consumer at the position it occurred. Each ``__iter__``
    spawns a fresh thread, so one Prefetcher can wrap a re-iterable loader
    (e.g. ``BatchIterable``) across epochs. If the consumer abandons the
    iterator early, the thread parks on the bounded queue and is released by
    ``close()`` (also called by the generator's ``finally``).
    """

    def __init__(self, iterable: Iterable, depth: int = 2):
        assert depth >= 1
        self.iterable = iterable
        self.depth = depth

    def __len__(self):
        return len(self.iterable)

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        stop = threading.Event()
        _END = object()

        def produce():
            try:
                for item in self.iterable:
                    while not stop.is_set():
                        try:
                            q.put(("item", item), timeout=0.1)
                            break
                        except queue.Full:
                            continue
                    if stop.is_set():
                        return
                q.put(("end", _END))
            except BaseException as e:  # re-raised consumer-side
                q.put(("error", e))

        t = threading.Thread(target=produce, daemon=True)
        t.start()  # eager: production overlaps work done before first next()

        def consume():
            try:
                while True:
                    kind, payload = q.get()
                    if kind == "end":
                        return
                    if kind == "error":
                        raise payload
                    yield payload
            finally:
                stop.set()

        return consume()


def prefetch(iterable: Iterable, depth: int = 2) -> Iterable:
    """Wrap ``iterable`` in a Prefetcher; ``depth=0`` returns it unchanged."""
    if depth <= 0:
        return iterable
    return Prefetcher(iterable, depth)


def stage_batches(batches: Iterable, pin: bool) -> Iterator:
    """Yield each ``(x, y, w)`` of ``batches`` as ``((x, y, w), host)``:
    ``host`` is the same batch as CPU tensors ``(x_dict, y, w)``, ``y``
    float32 (None for an unlabeled batch), in pinned (page-locked) memory
    when ``pin``. The numpy batch stays beside it for reads on the host.

    A pinned block is not reused while a copy from it is in flight:
    PyTorch's caching host allocator records the copy's stream event and
    keeps the freed block until that event has completed."""
    def host(a, dtype=None):
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(a, dtype)))
        return t.pin_memory() if pin else t

    for x, y, w in batches:
        yield (x, y, w), ({k: host(v) for k, v in x.items()},
                          None if y is None else host(y, np.float32), host(w))


class Dispatch(NamedTuple):
    """``n`` host batches of ``b`` rows packed for one dispatch of the train
    step: ``ints [n·b, n_int]`` int32, ``floats [n·b, n_float + 1]`` float32
    with the label last, ``w [n·b]`` the padding weights, in pinned memory
    when staged with ``pin`` (``layout``: :func:`data.device.column_layout`
    of the batches' columns)."""

    n: int
    b: int
    layout: dict
    ints: torch.Tensor
    floats: torch.Tensor
    w: torch.Tensor


def _pack(group, pin: bool) -> Dispatch:
    x0 = group[0][0]
    layout, n_int, n_float = column_layout(x0)
    n, b = len(group), len(group[0][2])
    ints = torch.empty((n * b, n_int), dtype=torch.int32, pin_memory=pin)
    floats = torch.empty((n * b, n_float + 1), dtype=torch.float32, pin_memory=pin)
    w = torch.empty((n * b,), dtype=torch.float32, pin_memory=pin)
    ints_np, floats_np, w_np = ints.numpy(), floats.numpy(), w.numpy()
    for i, (x, y, wb) in enumerate(group):
        rows = slice(i * b, (i + 1) * b)
        pack_columns(x, layout, ints_np[rows], floats_np[rows])
        floats_np[rows, n_float] = np.asarray(y, np.float32)
        w_np[rows] = np.asarray(wb, np.float32)
    return Dispatch(n, b, layout, ints, floats, w)


def stage_dispatches(batches: Iterable, steps: int, pin: bool) -> Iterator[Dispatch]:
    """Group the ``(x, y, w)`` of ``batches`` into :class:`Dispatch` es of
    ``steps`` batches each; the last holds the remainder (fewer). A batch of
    another size or other columns than the group's closes the group. Each
    dispatch's matrices are fresh blocks: PyTorch's caching host allocator
    keeps a pinned block until the copy from it has completed."""
    def key(batch):
        x, _, w = batch
        return len(w), tuple((k, np.asarray(v).dtype.kind, np.shape(v)[1:])
                             for k, v in x.items())

    group = []
    for batch in batches:
        if batch[1] is None:
            raise ValueError("training needs labeled batches")
        if group and key(batch) != key(group[0]):
            yield _pack(group, pin)
            group = []
        group.append(batch)
        if len(group) == steps:
            yield _pack(group, pin)
            group = []
    if group:
        yield _pack(group, pin)
