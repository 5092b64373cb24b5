"""Sorted dense Adam on the packed embedding table: the CUDA kernel
``csrc/sorted_adam.cu`` and its plain PyTorch version.

The sorted embedding update of the training step. The batch's embedding
gradient arrives as one row per id occurrence (``[K, D]``, the gradient with
respect to the gathered rows); the update sums the rows of duplicate ids and
applies exact torch-Adam, weight decay folded into the gradient, to **every**
row of the ``[V, D]`` table and its two moments, touched or not. That is the
reference's ``torch.optim.Adam`` over ``nn.Embedding.weight``, computed
without a dense ``[V, D]`` gradient. It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/sorted_adam.py:sorted_dense_adam_apply``
(the design note is at the top of the source).

The port's layout is the plain ``[V, D]`` table: the TPU's packed
``[V2/r, 128]`` tiles and whole-block padding are not carried over. The
kernel updates ``table``, ``mu`` and ``nu`` **in place** (the JAX kernel
aliases its inputs to its outputs); so does the plain version.

Like the TPU kernel it takes the three in float32 or all three in bfloat16
(``CTRTrainer(sorted_dtype="bf16")``, half the bytes to stream); the ids are
int32 and the gradient rows float32 either way. The bf16 form does the Adam
math in float32 and rounds each stored value to nearest even, as the JAX
package's ``astype`` does.

:func:`sorted_dense_adam_apply_sharded` is the same update on one row shard
of a table that a mesh row-shards over its ``embed`` axis (the TPU kernel
``sorted_dense_adam_apply_sharded``): the shard's ``[V/E, D]`` rows, the
whole table's sorted ids, and ``row0``, the shard's first row. Its kernel is
the same code, whose tiles are the whole table's tiles that meet the shard,
so the shards of a table together equal one unsharded call bit for bit.

:func:`sorted_dense_adam_apply` (and the sharded form) takes the plain
version for a tensor on the CPU and launches the kernel for one on a CUDA
device, or raises; it never falls back. ``sorted_dense_adam_apply.launches``
counts launches of the f32 form, ``.launches_bf16`` those of the bf16 form,
``.launches_sharded`` and ``.launches_sharded_bf16`` those of the sharded
form; a launch recorded into a CUDA graph capture counts in ``.captured``,
``.captured_bf16``, ``.captured_sharded`` or ``.captured_sharded_bf16``
instead (it runs once at each replay of the graph).

The 7 Adam numbers ``hp`` come as host floats (passed to the kernel by
value) or as a ``[7]`` float32 tensor on the table's device, which the
kernel reads from device memory: the form a CUDA graph of the train step
captures once and replays with each step's numbers
(``CTRTrainer(scan_steps=S)``). :func:`adam_hparams_rows` computes them for
a run of steps, on the host, as :func:`adam_hparams` does.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

# Vocab rows one thread block owns on the card: the fastest of 64..2048 in
# chip_smoke.py's sweep at the Ali-CCP shape (V = 10,741,000, D = 16,
# K = 94,208) on an H100 SXM, both with uniform ids and with one 4096-long
# hot row plus Zipf ids; 64..1024 lie within 4 % of each other there.
DEFAULT_BLOCK_ROWS = 128
# The same for the bf16 form, which moves half the bytes a row: the fastest
# in chip_smoke.py's sweep at the same shape with uniform ids on an H100 SXM
# (0.7298 ms; 256 and 1024 within 3 %, 128 13 % slower); with the hot row,
# 256 (0.7847) and 512 (0.8060).
DEFAULT_BLOCK_ROWS_BF16 = 512
PRECISIONS = (None, "fast", "split", "highest")
_SMEM_LIMIT = 232_448  # bytes of shared memory a Hopper block may opt into


def adam_hparams(step: int, lr: float, weight_decay: float, b1: float,
                 b2: float, eps: float) -> Tuple[float, ...]:
    """``(lr, wd, b1, b2, 1/(1-b1^t), 1/(1-b2^t), eps)`` for step ``t``,
    computed on the host in float32 as the JAX package computes its ``hp``
    vector. Each is a Python float that float32 represents exactly, so the
    kernel and the plain version see the same values; no device sync."""
    f = np.float32
    t = f(step)
    bc1r = f(1.0) / (f(1.0) - f(b1) ** t)
    bc2r = f(1.0) / (f(1.0) - f(b2) ** t)
    return tuple(float(f(v)) for v in (lr, weight_decay, b1, b2, bc1r, bc2r, eps))


def adam_hparams_rows(step0: int, n: int, lr: float, weight_decay: float,
                      b1: float, b2: float, eps: float) -> np.ndarray:
    """``[n, 7]`` float32: row ``i`` is :func:`adam_hparams` of step
    ``step0 + i``, the numbers of ``n`` consecutive steps."""
    return np.array([adam_hparams(step0 + i, lr, weight_decay, b1, b2, eps)
                     for i in range(n)], np.float32).reshape(n, 7)


def _hp32(hp) -> Tuple[float, ...]:
    """The 7 Adam numbers as float32-exact host floats. A tensor ``hp`` is
    read from its device: no sync on the CPU."""
    if isinstance(hp, torch.Tensor):
        hp = hp.detach().reshape(-1).tolist()
    if len(hp) != 7:
        raise ValueError(f"hp must hold 7 numbers, got {len(hp)}")
    return tuple(float(np.float32(v)) for v in hp)


def _check_hp_tensor(hp: torch.Tensor, table: torch.Tensor) -> None:
    if hp.dtype != torch.float32 or hp.shape != (7,):
        raise ValueError(f"a tensor hp must be float32 [7], got {hp.dtype} "
                         f"{tuple(hp.shape)}")
    if hp.device != table.device or not hp.is_contiguous():
        raise ValueError(f"a tensor hp must be contiguous on the table's device "
                         f"{table.device}, got {hp.device}")


def owner_sorted_grads(ids: torch.Tensor, g_rows: torch.Tensor, segments=(),
                       offsets=None, reorder: str = "gather"):
    """Globally sorted ``(ids int32 [K], grads [K, D])``.

    The JAX package sorts each owner's ids separately (``segments``: the
    ``(owner, start, size)`` layout of ``EmbeddingCollection.touched_ids``)
    and concatenates the owners in ``offsets`` order. Every id lies in its
    owner's span (``touched_ids`` clips it there) and the spans are disjoint
    and ascending, so one stable sort of all the ids gives the same order;
    both sorts are stable, so duplicates keep their order of occurrence and
    the outputs are equal bit for bit. ``reorder`` ("gather" | "payload")
    chose how the TPU moved the gradient rows; here both are one stable sort
    and one row gather.
    """
    check_jax_dials(reorder=reorder)
    if ids.ndim != 1 or g_rows.ndim != 2 or g_rows.shape[0] != ids.shape[0]:
        raise ValueError(f"ids [K] and g_rows [K, D] expected, got "
                         f"{tuple(ids.shape)} and {tuple(g_rows.shape)}")
    if segments and sum(size for _, _, size in segments) != ids.shape[0]:
        raise ValueError("segments do not cover the ids")
    sorted_ids, perm = torch.sort(ids.to(torch.int32), stable=True)
    return sorted_ids, g_rows[perm]


STORAGE = (torch.float32, torch.bfloat16)  # table, mu and nu: all of one


def _check(table, mu, nu, sorted_ids, g_sorted):
    if table.ndim != 2:
        raise ValueError(f"table must be [V, D], got {tuple(table.shape)}")
    V, D = table.shape
    if mu.shape != table.shape or nu.shape != table.shape:
        raise ValueError("mu and nu must have the table's shape")
    if sorted_ids.ndim != 1 or sorted_ids.dtype != torch.int32:
        raise ValueError(f"sorted_ids must be int32 [K], got {sorted_ids.dtype} "
                         f"{tuple(sorted_ids.shape)}")
    if g_sorted.shape != (sorted_ids.shape[0], D):
        raise ValueError(f"g_sorted must be [{sorted_ids.shape[0]}, {D}], got "
                         f"{tuple(g_sorted.shape)}")
    dtypes = (table.dtype, mu.dtype, nu.dtype)
    if table.dtype not in STORAGE or len(set(dtypes)) != 1:
        raise ValueError(f"table, mu and nu must be all float32 or all bfloat16, got "
                         f"{[str(t) for t in dtypes]}")
    if g_sorted.dtype != torch.float32:
        raise ValueError(f"g_sorted must be float32, got {g_sorted.dtype}")
    return V, D


def check_jax_dials(chunk_ids: int = 128, precision=None, reorder: str = "gather"):
    """Check the JAX kernel's dials, accepted for its signature and unused
    on the card: ``chunk_ids`` (a positive multiple of 128), ``precision``
    (one of :data:`PRECISIONS`) and ``reorder`` ("gather" | "payload")."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    if chunk_ids <= 0 or chunk_ids % 128:
        raise ValueError(f"chunk_ids must be a positive multiple of 128, got {chunk_ids}")
    if reorder not in ("gather", "payload"):
        raise ValueError(f"reorder must be 'gather' or 'payload', got {reorder!r}")


def sorted_dense_adam_apply_ref(table, mu, nu, sorted_ids, g_sorted, hp,
                                **dials):
    """The plain PyTorch version: the math of the JAX package's
    ``fused_dense_adam_ref`` (``ops/pallas/fused_adam.py:172-183``), a dense
    ``index_add_`` of the gradient rows and vectorised Adam, each step of the
    chain one elementwise op. Ids outside ``[0, V)`` add nothing. A bf16
    trio is read as float32, takes the same chain and is written back
    rounded to nearest even: the JAX package's XLA path for bf16 storage
    (``train/optim.py:497-508``). In place; returns ``(table, mu, nu)``.
    ``dials`` are the kernel's and mean nothing here. ``hp``: 7 host numbers
    or a ``[7]`` float32 tensor (read once; a sync only on the card)."""
    _check(table, mu, nu, sorted_ids, g_sorted)
    if table.dtype == torch.bfloat16:
        wide = [t.float() for t in (table, mu, nu)]
        sorted_dense_adam_apply_ref(*wide, sorted_ids, g_sorted, hp)
        with torch.no_grad():
            for t, w in zip((table, mu, nu), wide):
                t.copy_(w.to(torch.bfloat16))
        return table, mu, nu
    V = table.shape[0]
    lr, wd, b1, b2, bc1r, bc2r, eps = _hp32(hp)
    omb1 = float(np.float32(1.0) - np.float32(b1))
    omb2 = float(np.float32(1.0) - np.float32(b2))
    ids = sorted_ids.long()
    keep = (ids >= 0) & (ids < V)
    with torch.no_grad():
        g = torch.zeros_like(table).index_add_(
            0, ids.clamp(0, V - 1), torch.where(keep[:, None], g_sorted, 0.0))
        g = g + wd * table
        mu.mul_(b1).add_(omb1 * g)
        nu.mul_(b2).add_(omb2 * (g * g))
        table.sub_(lr * (mu * bc1r) / (torch.sqrt(nu * bc2r) + eps))
    return table, mu, nu


def sorted_dense_adam_apply_sharded_ref(table, mu, nu, sorted_ids, g_sorted, hp, *,
                                        row0: int, **dials):
    """The plain version of :func:`sorted_dense_adam_apply_sharded`: the ids
    re-based to the shard (``id - row0``; those outside it then fall outside
    ``[0, V/E)`` and add nothing) and :func:`sorted_dense_adam_apply_ref`.
    In place; returns ``(table, mu, nu)``."""
    _check_row0(row0, table)
    local = (sorted_ids.long() - int(row0)).clamp(-1, table.shape[0]).to(torch.int32)
    return sorted_dense_adam_apply_ref(table, mu, nu, local, g_sorted, hp)


def _check_row0(row0, table):
    if int(row0) < 0 or int(row0) + table.shape[0] >= 2 ** 31 - 1:
        raise ValueError(f"row0 must place the shard's {table.shape[0]} rows inside "
                         f"[0, 2^31 - 1), got {row0}")


@functools.lru_cache(maxsize=None)
def _lib():
    from . import _build

    lib = _build.load("sorted_adam")
    p, i, f, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
    # every entry takes (table, mu, nu, ids, g, starts, v, row0, d, k,
    # block_rows), then the 7 Adam numbers by value or a device pointer, then
    # the stream
    for entry in (lib.sorted_dense_adam_f32, lib.sorted_dense_adam_bf16):
        entry.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i, f, f, f, f, f, f, f, p]
        entry.restype = ctypes.c_int
    for entry in (lib.sorted_dense_adam_f32_dev, lib.sorted_dense_adam_bf16_dev):
        entry.argtypes = [p, p, p, p, p, p, ll, ll, i, i, i, p, p]
        entry.restype = ctypes.c_int
    lib.sorted_dense_adam_smem_bytes.argtypes = [i, i]
    lib.sorted_dense_adam_smem_bytes.restype = ctypes.c_size_t
    return lib


def sorted_dense_adam_apply(table: torch.Tensor, mu: torch.Tensor,
                            nu: torch.Tensor, sorted_ids: torch.Tensor,
                            g_sorted: torch.Tensor, hp, *,
                            block_rows: Optional[int] = None,
                            chunk_ids: int = 128,
                            precision=None):
    """One dense-Adam pass over ``table``, ``mu``, ``nu`` (``[V, D]``, all
    float32 or all bfloat16), in place. Returns ``(table, mu, nu)``.

    Args:
        sorted_ids: ``[K]`` int32, ascending (:func:`owner_sorted_grads`).
            Duplicates sum; ids outside ``[0, V)`` contribute nothing (the
            sharded path relies on it). ``K == 0`` still decays every row.
        g_sorted: ``[K, D]`` f32 gradient rows aligned with ``sorted_ids``.
        hp: 7 host numbers ``(lr, wd, b1, b2, 1/(1-b1^t), 1/(1-b2^t), eps)``
            (:func:`adam_hparams`), passed to the kernel by value; or the
            same as a ``[7]`` float32 tensor on the table's device, which
            the kernel reads from device memory (each block loads it once),
            so a captured launch takes the numbers ``hp`` holds at replay.
        block_rows: vocab rows one thread block owns on the card (default:
            :data:`DEFAULT_BLOCK_ROWS`, or :data:`DEFAULT_BLOCK_ROWS_BF16`
            for a bf16 trio).
        chunk_ids: the TPU kernel's id-chunk width; it means nothing on the
            card and is only checked (a positive multiple of 128).
        precision: "fast" | "split" | "highest" | None (None: "split" for
            f32 storage, "fast" for bf16, as in the JAX package). On the TPU
            these set how the one-hot segment sum rounds its gradient
            operand to bf16; on the card no operand is rounded and all four
            sum in f32, in either storage type.
    """
    return _apply(table, mu, nu, sorted_ids, g_sorted, hp, None, block_rows, chunk_ids,
                  precision)


def sorted_dense_adam_apply_sharded(table: torch.Tensor, mu: torch.Tensor,
                                    nu: torch.Tensor, sorted_ids: torch.Tensor,
                                    g_sorted: torch.Tensor, hp, *, row0: int,
                                    block_rows: Optional[int] = None,
                                    chunk_ids: int = 128, precision=None):
    """:func:`sorted_dense_adam_apply` on one row shard: ``table``, ``mu``
    and ``nu`` (``[V/E, D]``, all float32 or all bfloat16) hold the rows
    ``[row0, row0 + V/E)`` of the table that ``sorted_ids`` address (int32
    ``[K]``, ascending, the whole batch's: ``owner_sorted_grads`` of the
    ids and gradient rows gathered over the mesh's ``data`` axis). Ids
    outside the shard contribute nothing; every row of the shard decays. In
    place; returns ``(table, mu, nu)``. The other arguments are
    :func:`sorted_dense_adam_apply`'s. Two launches a call, as there."""
    _check_row0(row0, table)
    return _apply(table, mu, nu, sorted_ids, g_sorted, hp, int(row0), block_rows,
                  chunk_ids, precision)


def _apply(table, mu, nu, sorted_ids, g_sorted, hp, row0, block_rows, chunk_ids,
           precision):
    """The two wrappers' launch: ``row0`` None is the unsharded form."""
    check_jax_dials(chunk_ids, precision)
    if block_rows is None:
        block_rows = (DEFAULT_BLOCK_ROWS_BF16 if table.dtype == torch.bfloat16
                      else DEFAULT_BLOCK_ROWS)
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    on_device = isinstance(hp, torch.Tensor)
    if on_device:
        _check_hp_tensor(hp, table)
    sharded = row0 is not None
    if table.device.type == "cpu":
        if sharded:
            return sorted_dense_adam_apply_sharded_ref(table, mu, nu, sorted_ids, g_sorted,
                                                       hp, row0=row0)
        return sorted_dense_adam_apply_ref(table, mu, nu, sorted_ids, g_sorted, hp)
    if table.device.type != "cuda":
        raise ValueError(f"sorted_dense_adam_apply runs on cuda or cpu, not {table.device}")
    V, D = _check(table, mu, nu, sorted_ids, g_sorted)
    for t in (mu, nu, sorted_ids, g_sorted):
        if t.device != table.device:
            raise ValueError(f"tensor on {t.device}, table on {table.device}")
    for t in (table, mu, nu, sorted_ids, g_sorted):
        if not t.is_contiguous():
            raise ValueError("sorted_dense_adam_apply takes contiguous tensors")
    if V >= 2 ** 31 - 1:
        raise ValueError(f"int32 ids address at most 2^31 - 2 rows, got V = {V}")
    lib = _lib()
    smem = lib.sorted_dense_adam_smem_bytes(D, block_rows)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"block_rows={block_rows} at D={D} needs {smem} bytes of "
                         f"shared memory per block, more than {_SMEM_LIMIT}")
    # the whole table's tiles that meet the shard (csrc/embedding_adam.cuh)
    first = row0 or 0
    nb = (first + V + block_rows - 1) // block_rows - first // block_rows
    starts = torch.empty(nb + 1, dtype=torch.int32, device=table.device)
    stream = torch.cuda.current_stream(table.device).cuda_stream
    bf16 = table.dtype == torch.bfloat16
    ptrs = (table.data_ptr(), mu.data_ptr(), nu.data_ptr(), sorted_ids.data_ptr(),
            g_sorted.data_ptr(), starts.data_ptr())
    name = "sorted_dense_adam_" + ("bf16" if bf16 else "f32") + ("_dev" if on_device else "")
    with torch.cuda.device(table.device):
        hp_args = (hp.data_ptr(),) if on_device else _hp32(hp)
        err = getattr(lib, name)(*ptrs, V, first, D, sorted_ids.shape[0], block_rows,
                                 *hp_args, stream)
    if err != 0:
        raise RuntimeError(
            f"{name} launch failed with cudaError {err} ({smem} bytes of shared memory "
            f"per block, block_rows={block_rows})")
    # a launch recorded into a CUDA graph runs at each replay, not here
    suffix = ("_sharded" if sharded else "") + ("_bf16" if bf16 else "")
    kind = "captured" if torch.cuda.is_current_stream_capturing() else "launches"
    setattr(sorted_dense_adam_apply, kind + suffix,
            getattr(sorted_dense_adam_apply, kind + suffix) + 1)
    return table, mu, nu


# launches of each form: f32, bf16, and the sharded form in f32 and bf16; and
# those recorded into CUDA graph captures (each runs once a replay)
for _kind in ("launches", "captured"):
    for _form in ("", "_bf16", "_sharded", "_sharded_bf16"):
        setattr(sorted_dense_adam_apply, _kind + _form, 0)
