"""Exact dense Adam on the packed embedding table from per-segment sorted
ids: the CUDA kernel ``csrc/fused_adam.cu`` and its plain PyTorch version.

The ``dense`` embedding update of the training step. Like the sorted update
(``sorted_adam.py``) it applies exact torch-Adam, weight decay folded into
the gradient, to **every** row of the ``[V, D]`` table and its moments, from
the batch's per-occurrence gradient rows; it differs in its inputs: the
gradient rows stay in their original order and are read through
``sorted_pos``, and the ids are sorted within each segment (one per
feature), not globally. It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/fused_adam.py:fused_dense_adam_apply``
(the design note is at the top of the source; the device code is shared
with the sorted kernel through ``csrc/embedding_adam.cuh``).

The JAX kernel takes ``starts`` computed by its caller for its vocab block;
here ``block_rows`` is the port's own tile and the kernel computes
``starts`` for it from the segments' sizes. ``table``, ``mu`` and ``nu`` are
updated **in place**, by the plain version too.

:func:`fused_dense_adam_apply` takes the plain version for a tensor on the
CPU and launches the kernel for one on a CUDA device, or raises; it never
falls back. ``fused_dense_adam_apply.launches`` counts kernel launches; a
launch recorded into a CUDA graph capture counts in ``.captured`` instead
(it runs once at each replay of the graph).

The 7 Adam numbers ``hp`` come as host floats (passed to the kernel by
value) or as a ``[7]`` float32 tensor on the table's device, which the
kernel reads from device memory: the form a CUDA graph of the train step
captures once and replays with each step's numbers, as the sorted kernel's
(``sorted_adam.py``). The segment offsets are a device row made once per
segment layout, so a call copies nothing from the host.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from .sorted_adam import (_SMEM_LIMIT, _check, _check_hp_tensor, _hp32,
                          sorted_dense_adam_apply_ref)

# Vocab rows one thread block owns on the card: the fastest of 64..1024 in
# chip_smoke.py's sweep at the Ali-CCP shape (V = 10,741,000, D = 16, 23
# segments of 4096 ids) on an H100 SXM, 1.50 ms against 1.72 at the sorted
# kernel's 128: a tile walks all 23 segments' spans, so fewer tiles pay less.
DEFAULT_BLOCK_ROWS = 256


def fused_dense_adam_ref(table, mu, nu, g_rows, ids, hp):
    """The plain PyTorch version (the math of the JAX package's
    ``fused_dense_adam_ref``): a dense ``index_add_`` of the gradient rows at
    ``ids [K]`` (any order, duplicates sum, ids outside ``[0, V)`` add
    nothing) and vectorised Adam. ``hp``: 7 host numbers or a ``[7]``
    float32 tensor. In place; returns ``(table, mu, nu)``."""
    return sorted_dense_adam_apply_ref(table, mu, nu, ids.to(torch.int32), g_rows, hp)


def _check_segments(k, sizes):
    sizes = [int(s) for s in sizes] or [0]
    if any(s < 0 for s in sizes) or sum(sizes) != k:
        raise ValueError(f"segment sizes {sizes} do not cover the {k} ids")
    return sizes


@functools.lru_cache(maxsize=None)
def _lib():
    from . import _build

    lib = _build.load("fused_adam")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_dense_adam_f32.argtypes = [
        p, p, p, p, p, p, p, i, p, ctypes.c_longlong, i, i, i, f, f, f, f, f, f, f, p]
    lib.fused_dense_adam_f32.restype = ctypes.c_int
    lib.fused_dense_adam_f32_dev.argtypes = [
        p, p, p, p, p, p, p, i, p, ctypes.c_longlong, i, i, i, p, p]
    lib.fused_dense_adam_f32_dev.restype = ctypes.c_int
    lib.fused_dense_adam_smem_bytes.argtypes = [i, i, i]
    lib.fused_dense_adam_smem_bytes.restype = ctypes.c_size_t
    return lib


@functools.lru_cache(maxsize=64)
def _segment_offsets(sizes: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    """The segments' offsets ``[S + 1]`` int32 on ``device``, made once per
    layout (and outside inference mode, so that a train step may use one an
    eval pass made): a call copies nothing from the host, so a CUDA graph
    can capture it."""
    offsets = [0]
    for s in sizes:
        offsets.append(offsets[-1] + s)
    with torch.inference_mode(False):
        return torch.tensor(offsets, dtype=torch.int32, device=device)


def fused_dense_adam_apply(table: torch.Tensor, mu: torch.Tensor, nu: torch.Tensor,
                           g_rows: torch.Tensor, sorted_ids: torch.Tensor,
                           sorted_pos: torch.Tensor, segment_sizes: Sequence[int],
                           hp, *,
                           block_rows: int = DEFAULT_BLOCK_ROWS):
    """One dense-Adam pass over ``table``, ``mu``, ``nu`` (``[V, D]`` f32),
    in place. Returns ``(table, mu, nu)``.

    Args:
        g_rows: ``[K, D]`` f32 per-occurrence gradient rows in their
            original order (the gradient with respect to
            ``table[touched_ids]``).
        sorted_ids: ``[K]`` int32, ascending within each segment; ids
            outside ``[0, V)`` contribute nothing. ``K == 0`` still decays
            every row.
        sorted_pos: ``[K]`` int32, the row of ``g_rows`` of each sorted id.
        segment_sizes: the segments' lengths, in order; they cover ``K``.
        hp: 7 host numbers ``(lr, wd, b1, b2, 1/(1-b1^t), 1/(1-b2^t), eps)``
            (``sorted_adam.adam_hparams``), passed to the kernel by value; or
            the same as a ``[7]`` float32 tensor on the table's device, which
            the kernel reads from device memory, so a captured launch takes
            the numbers ``hp`` holds at replay.
        block_rows: vocab rows one thread block owns on the card.
    """
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    K = sorted_ids.shape[0] if sorted_ids.ndim == 1 else -1
    if sorted_pos.shape != sorted_ids.shape or K < 0:
        raise ValueError(f"sorted_ids and sorted_pos must be [K], got "
                         f"{tuple(sorted_ids.shape)} and {tuple(sorted_pos.shape)}")
    sizes = _check_segments(K, segment_sizes)
    on_device = isinstance(hp, torch.Tensor)
    if on_device:
        _check_hp_tensor(hp, table)
    if table.device.type == "cpu":
        return fused_dense_adam_ref(table, mu, nu, g_rows[sorted_pos.long()], sorted_ids, hp)
    if table.device.type != "cuda":
        raise ValueError(f"fused_dense_adam_apply runs on cuda or cpu, not {table.device}")
    if sorted_pos.dtype != torch.int32:
        raise ValueError(f"sorted_pos must be int32, got {sorted_pos.dtype}")
    V, D = _check(table, mu, nu, sorted_ids, g_rows)
    for t in (mu, nu, g_rows, sorted_ids, sorted_pos):
        if t.device != table.device:
            raise ValueError(f"tensor on {t.device}, table on {table.device}")
    for t in (table, mu, nu, g_rows, sorted_ids, sorted_pos):
        if not t.is_contiguous():
            raise ValueError("fused_dense_adam_apply takes contiguous tensors")
    if V >= 2 ** 31 - 1:
        raise ValueError(f"int32 ids address at most 2^31 - 2 rows, got V = {V}")
    lib = _lib()
    smem = lib.fused_dense_adam_smem_bytes(D, block_rows, len(sizes))
    if smem > _SMEM_LIMIT:
        raise ValueError(f"block_rows={block_rows} at D={D} with {len(sizes)} segments needs "
                         f"{smem} bytes of shared memory per block, more than {_SMEM_LIMIT}")
    seg_off = _segment_offsets(tuple(sizes), table.device)
    nb = -(-V // block_rows)
    starts = torch.empty(len(sizes) * (nb + 1), dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    args = (table.data_ptr(), mu.data_ptr(), nu.data_ptr(), g_rows.data_ptr(),
            sorted_ids.data_ptr(), sorted_pos.data_ptr(), seg_off.data_ptr(), len(sizes),
            starts.data_ptr(), V, D, K, block_rows)
    with torch.cuda.device(table.device):
        if on_device:
            err = lib.fused_dense_adam_f32_dev(*args, hp.data_ptr(), stream)
        else:
            err = lib.fused_dense_adam_f32(*args, *_hp32(hp), stream)
    if err != 0:
        raise RuntimeError(
            f"fused_dense_adam_apply launch failed with cudaError {err} "
            f"({smem} bytes of shared memory per block, block_rows={block_rows})")
    # a launch recorded into a CUDA graph runs at each replay, not here
    if torch.cuda.is_current_stream_capturing():
        fused_dense_adam_apply.captured += 1
    else:
        fused_dense_adam_apply.launches += 1
    return table, mu, nu


fused_dense_adam_apply.launches = 0
# launches recorded into CUDA graph captures (each runs once a replay)
fused_dense_adam_apply.captured = 0
