"""The lazy embedding update's row primitives: the CUDA kernels of
``csrc/row_update.cu`` and their plain PyTorch versions.

- :func:`occurrence_segsum`: for every id occurrence, the sum of the
  gradients of all occurrences of the same id in its row, ``out[f, i] =
  sum_j [ids[f, i] == ids[f, j]] g[f, j]``. Every duplicate receives a
  bit-identical sum, which makes the row writes that follow idempotent.
  Replaces ``scenario_wise_rec_tpu/ops/pallas/row_update.py:occurrence_segsum``.
- :func:`scatter_rows`: ``dst[ids[k]] = rows[k]`` in place; a negative id
  wraps once, ids still outside ``[0, V)`` are dropped, and duplicate ids
  must carry identical rows.
  Replaces ``scenario_wise_rec_tpu/ops/pallas/row_update.py:scatter_rows``.

The design notes are at the top of the source. On the card the segment sum
is sort-based, not the TPU's equality-mask matmul: a row of up to 16384 ids
is sorted in shared memory inside the one launch; a longer row is sorted by
``torch.sort`` before its launch. Both kernels read int32 or int64 ids as
the trainer passes them. The JAX functions' dials
(``tile``; ``nslots``, ``chunk``, ``force_xla``) shape the TPU kernels only:
here they are checked and unused.

Each wrapper takes its plain version for a tensor on the CPU and launches its
kernel for one on a CUDA device, or raises; it never falls back.
``<wrapper>.launches`` counts kernel launches; a launch recorded into a CUDA
graph capture counts in ``<wrapper>.captured`` instead (it runs once at each
replay of the graph).
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch


def _positive(name, value):
    if isinstance(value, bool) or int(value) != value or value <= 0:
        raise ValueError(f"{name} must be a positive int, got {value!r}")


def _check_segsum(ids, g):
    if ids.ndim != 2 or g.ndim != 3 or tuple(g.shape[:2]) != tuple(ids.shape):
        raise ValueError(f"ids [F, N] and g [F, N, D] expected, got {tuple(ids.shape)} "
                         f"and {tuple(g.shape)}")
    if g.dtype != torch.float32:
        raise ValueError(f"occurrence_segsum takes float32 gradients, got {g.dtype}")


def occurrence_segsum_ref(ids: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, O(F·N·D): the distinct (row, id) pairs
    (``unique`` with ``return_inverse``), an ``index_add_`` of the gradient
    rows into them and a gather back to every occurrence, which reads one
    sum per id. No ``[F, N, N]`` mask is built."""
    _check_segsum(ids, g)
    F, N, D = g.shape
    row = torch.arange(F, device=ids.device)[:, None].expand(F, N)
    key = (row << 32) | (ids.to(torch.int64) & 0xFFFFFFFF)
    _, inv = torch.unique(key.reshape(-1), return_inverse=True)
    sums = torch.zeros(F * N, D, dtype=g.dtype, device=g.device)
    sums.index_add_(0, inv, g.reshape(-1, D))
    return sums[inv].reshape(F, N, D)


# csrc/row_update.cu's kRowLimit: the longest row that the segment sum sorts
# in shared memory (longer rows take torch.sort and the sorted kernel); and
# its kLongRun: runs longer than this are summed by a whole block
ROW_LIMIT, LONG_RUN = 16384, 64


@functools.lru_cache(maxsize=None)
def _lib():
    from . import _build

    lib = _build.load("row_update")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    for getter in (lib.occurrence_segsum_row_limit, lib.occurrence_segsum_long_run):
        getter.argtypes, getter.restype = [], ctypes.c_int
    if (lib.occurrence_segsum_row_limit(), lib.occurrence_segsum_long_run()) != (
            ROW_LIMIT, LONG_RUN):
        raise RuntimeError("csrc/row_update.cu's kRowLimit and kLongRun differ from "
                           "ROW_LIMIT and LONG_RUN")
    lib.occurrence_segsum_rows_f32.argtypes = [p, i, p, p, i, i, i, i, p]
    lib.occurrence_segsum_rows_f32.restype = ctypes.c_int
    lib.occurrence_segsum_sorted_f32.argtypes = [p, p, p, p, ll, i, i, p]
    lib.occurrence_segsum_sorted_f32.restype = ctypes.c_int
    lib.scatter_rows_f32.argtypes = [p, p, i, p, i, i, ll, p]
    lib.scatter_rows_f32.restype = ctypes.c_int
    return lib


def _cuda_only(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, expected {dev}")


def _count(wrapper):
    """One more launch of ``wrapper``'s kernel: under a CUDA graph capture
    in ``.captured`` (the kernel runs at each replay, not here), else in
    ``.launches``."""
    if torch.cuda.is_current_stream_capturing():
        wrapper.captured += 1
    else:
        wrapper.launches += 1


def _int_ids(name, ids):
    if ids.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"{name} takes int32 or int64 ids on the card, got {ids.dtype}")


@functools.lru_cache(maxsize=None)
def _splits(rows: int, device: int) -> int:
    """Blocks per row of the shared-memory segment sum: as many as the
    card's SMs hold one each (every block sorts its row again and takes a
    share of its runs, so a second block on an SM doubles the sorts there;
    the result does not depend on it)."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    return max(1, min(16, sms // rows))


def occurrence_segsum(ids: torch.Tensor, g: torch.Tensor, *, tile: int = 256) -> torch.Tensor:
    """Per-occurrence duplicate-gradient sum: ids ``[F, N]`` (int32 or int64
    on the card, compared by their low 32 bits), g ``[F, N, D]`` f32 ->
    ``[F, N, D]``. Rows of ``ids`` are independent. A row of at most
    ``ROW_LIMIT`` (16384) ids is one launch that sorts in shared memory
    (:func:`_splits` blocks a row, which leaves the result unchanged); a
    longer row is sorted by ``torch.sort`` first, then one launch. ``tile``
    is the TPU kernel's row tile, checked and unused."""
    _positive("tile", tile)
    if g.device.type == "cpu":
        return occurrence_segsum_ref(ids, g)
    _check_segsum(ids, g)
    _cuda_only("occurrence_segsum", g, ids)
    _int_ids("occurrence_segsum", ids)
    if g.device.index != torch.cuda.current_device():
        with torch.cuda.device(g.device):
            return occurrence_segsum(ids, g, tile=tile)
    F, N, D = g.shape
    out = torch.empty_like(g, memory_format=torch.contiguous_format)
    if F * N == 0:
        return out
    g, ids = g.contiguous(), ids.contiguous()
    lib = _lib()
    stream = torch._C._cuda_getCurrentRawStream(g.device.index)
    if N <= ROW_LIMIT:
        err = lib.occurrence_segsum_rows_f32(ids.data_ptr(), ids.dtype == torch.int64,
                                             g.data_ptr(), out.data_ptr(), F, N, D,
                                             _splits(F, g.device.index), stream)
    else:
        # int64 ids are grouped by their low 32 bits here too
        sid, idx = torch.sort(ids.to(torch.int32), dim=1, stable=True)
        err = lib.occurrence_segsum_sorted_f32(sid.data_ptr(), idx.data_ptr(), g.data_ptr(),
                                               out.data_ptr(), F * N, N, D, stream)
    if err != 0:
        raise RuntimeError(f"occurrence_segsum launch failed with cudaError {err}")
    _count(occurrence_segsum)
    return out


occurrence_segsum.launches = 0
occurrence_segsum.captured = 0


def _check_scatter(dst, ids, rows):
    if dst.ndim < 1 or ids.ndim != 1:
        raise ValueError(f"dst [V, ...] and ids [K] expected, got {tuple(dst.shape)} "
                         f"and {tuple(ids.shape)}")
    if tuple(rows.shape) != (ids.shape[0],) + tuple(dst.shape[1:]):
        raise ValueError(f"rows must be [{ids.shape[0]}, *{tuple(dst.shape[1:])}], got "
                         f"{tuple(rows.shape)}")
    if dst.dtype != torch.float32 or rows.dtype != torch.float32:
        raise ValueError(f"scatter_rows takes float32, got {dst.dtype} and {rows.dtype}")


def scatter_rows_ref(dst: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version: a negative id wraps once (``id + V``), then
    an indexed assignment of the rows whose id lies in ``[0, V)``, in place.
    Returns ``dst``."""
    _check_scatter(dst, ids, rows)
    V = dst.shape[0]
    ids = ids.long()
    ids = torch.where(ids < 0, ids + V, ids)
    keep = (ids >= 0) & (ids < V)
    with torch.no_grad():
        dst[ids[keep]] = rows[keep]
    return dst


def scatter_rows(dst: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor, *,
                 nslots: int = 32, chunk: int = 16384,
                 force_xla: bool = False) -> torch.Tensor:
    """In-place row scatter ``dst[ids[k]] = rows[k]``; returns ``dst``.

    ``dst [V, ...]`` (contiguous on the card) and ``rows [K, ...]`` share
    their trailing shape. Ids (int32 or int64 on the card) follow the JAX
    function's XLA form (``dst.at[ids].set(rows, mode="drop")``): a negative
    id wraps once (``id + V``), and what is still outside ``[0, V)`` is
    dropped by the kernel. Duplicate ids must carry identical rows (their
    writes race); an id in ``[-V, -1]`` and its wrapped twin are duplicates.
    ``nslots``, ``chunk`` and ``force_xla`` are the TPU kernel's DMA ring, id
    chunk and XLA switch, checked and unused."""
    _positive("nslots", nslots)
    _positive("chunk", chunk)
    if not isinstance(force_xla, bool):
        raise ValueError(f"force_xla must be a bool, got {force_xla!r}")
    if dst.device.type == "cpu":
        return scatter_rows_ref(dst, ids, rows)
    _check_scatter(dst, ids, rows)
    _cuda_only("scatter_rows", dst, ids, rows)
    _int_ids("scatter_rows", ids)
    if not dst.is_contiguous():
        raise ValueError("scatter_rows updates a contiguous dst in place")
    if dst.device.index != torch.cuda.current_device():
        with torch.cuda.device(dst.device):
            return scatter_rows(dst, ids, rows)
    V, K, W = dst.shape[0], ids.shape[0], math.prod(dst.shape[1:])
    if K >= 2 ** 31:
        raise ValueError(f"scatter_rows takes at most 2^31 - 1 rows, got K = {K}")
    if K == 0 or V == 0 or W == 0:
        return dst
    rows, ids = rows.contiguous(), ids.contiguous()
    err = _lib().scatter_rows_f32(dst.data_ptr(), ids.data_ptr(), ids.dtype == torch.int64,
                                  rows.data_ptr(), K, W, V,
                                  torch._C._cuda_getCurrentRawStream(dst.device.index))
    if err != 0:
        raise RuntimeError(f"scatter_rows launch failed with cudaError {err}")
    _count(scatter_rows)
    return dst


scatter_rows.launches = 0
scatter_rows.captured = 0
