"""The lazy embedding update's row primitives: the CUDA kernels of
``csrc/row_update.cu`` and their plain PyTorch versions.

- :func:`occurrence_segsum`: for every id occurrence, the sum of the
  gradients of all occurrences of the same id in its row, ``out[f, i] =
  sum_j [ids[f, i] == ids[f, j]] g[f, j]``. Every duplicate receives a
  bit-identical sum, which makes the row writes that follow idempotent.
  Replaces ``scenario_wise_rec_tpu/ops/pallas/row_update.py:occurrence_segsum``.
- :func:`scatter_rows`: ``dst[ids[k]] = rows[k]`` in place; ids outside
  ``[0, V)`` are dropped, and duplicate ids must carry identical rows.
  Replaces ``scenario_wise_rec_tpu/ops/pallas/row_update.py:scatter_rows``.

The design notes are at the top of the source. On the card the segment sum
is sort-based (one stable ``torch.sort`` of each row of ids, then the
kernel), not the TPU's equality-mask matmul. The JAX functions' dials
(``tile``; ``nslots``, ``chunk``, ``force_xla``) shape the TPU kernels only:
here they are checked and unused.

Each wrapper takes its plain version for a tensor on the CPU and launches its
kernel for one on a CUDA device, or raises; it never falls back.
``<wrapper>.launches`` counts kernel launches.
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


@functools.lru_cache(maxsize=None)
def _lib():
    from . import _build

    lib = _build.load("row_update")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.occurrence_segsum_f32.argtypes = [p, p, p, p, ll, i, i, p]
    lib.occurrence_segsum_f32.restype = ctypes.c_int
    lib.scatter_rows_f32.argtypes = [p, p, p, ll, i, ll, p]
    lib.scatter_rows_f32.restype = ctypes.c_int
    return lib


def _cuda_only(name, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {dev}")
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensor on {t.device}, expected {dev}")


def occurrence_segsum(ids: torch.Tensor, g: torch.Tensor, *,
                      tile: int = 256) -> torch.Tensor:
    """Per-occurrence duplicate-gradient sum: ids ``[F, N]``, g ``[F, N,
    D]`` f32 -> ``[F, N, D]``. Rows of ``ids`` are independent; ``tile`` is
    the TPU kernel's row tile, checked and unused."""
    _positive("tile", tile)
    if g.device.type == "cpu":
        return occurrence_segsum_ref(ids, g)
    _check_segsum(ids, g)
    _cuda_only("occurrence_segsum", g, ids)
    F, N, D = g.shape
    if F * N >= 2 ** 31:
        raise ValueError(f"int32 positions address at most 2^31 - 1 occurrences, got {F * N}")
    out = torch.empty_like(g, memory_format=torch.contiguous_format)
    if F * N == 0:
        return out
    g = g.contiguous()
    sid, idx = torch.sort(ids.to(torch.int32), dim=1, stable=True)
    perm = (idx + torch.arange(F, device=g.device)[:, None] * N).to(torch.int32)
    stream = torch.cuda.current_stream(g.device).cuda_stream
    with torch.cuda.device(g.device):
        err = _lib().occurrence_segsum_f32(sid.data_ptr(), perm.data_ptr(), g.data_ptr(),
                                           out.data_ptr(), F * N, N, D, stream)
    if err != 0:
        raise RuntimeError(f"occurrence_segsum launch failed with cudaError {err}")
    occurrence_segsum.launches += 1
    return out


occurrence_segsum.launches = 0


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
    """The plain PyTorch version: an indexed assignment of the rows whose id
    lies in ``[0, V)``, in place. Returns ``dst``."""
    _check_scatter(dst, ids, rows)
    keep = (ids >= 0) & (ids < dst.shape[0])
    with torch.no_grad():
        dst[ids[keep].long()] = rows[keep]
    return dst


def scatter_rows(dst: torch.Tensor, ids: torch.Tensor, rows: torch.Tensor, *,
                 nslots: int = 32, chunk: int = 16384,
                 force_xla: bool = False) -> torch.Tensor:
    """In-place row scatter ``dst[ids[k]] = rows[k]``; returns ``dst``.

    ``dst [V, ...]`` (contiguous on the card) and ``rows [K, ...]`` share
    their trailing shape; ids outside ``[0, V)`` are dropped; duplicate ids
    must carry identical rows (their writes race). ``nslots``, ``chunk`` and
    ``force_xla`` are the TPU kernel's DMA ring, id chunk and XLA switch,
    checked and unused."""
    _positive("nslots", nslots)
    _positive("chunk", chunk)
    if not isinstance(force_xla, bool):
        raise ValueError(f"force_xla must be a bool, got {force_xla!r}")
    if dst.device.type == "cpu":
        return scatter_rows_ref(dst, ids, rows)
    _check_scatter(dst, ids, rows)
    _cuda_only("scatter_rows", dst, ids, rows)
    if not dst.is_contiguous():
        raise ValueError("scatter_rows updates a contiguous dst in place")
    V, K, W = dst.shape[0], ids.shape[0], math.prod(dst.shape[1:])
    if V >= 2 ** 31:
        raise ValueError(f"int32 ids address at most 2^31 - 1 rows, got V = {V}")
    if K == 0 or V == 0 or W == 0:
        return dst
    # the kernel drops ids outside [0, V); other integer ids are clamped to
    # [-1, V] first, so that none wraps into range as int32
    ids32 = ids.clamp(-1, V).to(torch.int32) if ids.dtype != torch.int32 else ids.contiguous()
    rows = rows.contiguous()
    stream = torch.cuda.current_stream(dst.device).cuda_stream
    with torch.cuda.device(dst.device):
        err = _lib().scatter_rows_f32(dst.data_ptr(), ids32.data_ptr(), rows.data_ptr(),
                                      K, W, V, stream)
    if err != 0:
        raise RuntimeError(f"scatter_rows launch failed with cudaError {err}")
    scatter_rows.launches += 1
    return dst


scatter_rows.launches = 0
