"""What the fused eval wrappers share: the tensor and shape checks, the
stage list a kernel reads its weights from (pointers and ``(K, N)`` per
stage), the ctypes function and launch, and the plain versions' gate
mixture. ``sarnet_infer``, ``hamur_infer``, ``m2m_infer`` and
``gated_infer``'s EPNet wrapper launch through :func:`launch`;
``gated_infer``'s PPNet and AdaSparse wrappers, ``m3oe_infer``,
``tower_infer`` (with ``adaptdhm_infer`` and ``star_infer``) and
``ple_infer`` call :func:`function` themselves; ``mmoe_infer`` uses the
batch check and the ctypes arrays.

Nothing here builds or loads a kernel until :func:`launch` or
:func:`function` is called.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch

Affine = Tuple[torch.Tensor, torch.Tensor]


def check_batch(emb: torch.Tensor, domain_id: torch.Tensor):
    """``(B, F)`` of ``emb [B, F]`` with an integer ``domain_id [B]``."""
    if emb.ndim != 2:
        raise ValueError(f"emb must be [B, F], got {tuple(emb.shape)}")
    B, F = emb.shape
    if domain_id.shape != (B,):
        raise ValueError(f"domain_id must be [{B}], got {tuple(domain_id.shape)}")
    if domain_id.dtype.is_floating_point or domain_id.dtype == torch.bool:
        raise ValueError(f"domain_id must be integer, got {domain_id.dtype}")
    return B, F


def check_chain(what: str, stages: Sequence[Affine], lead: tuple, width: int) -> int:
    """Checks that ``stages`` (each ``W [*lead, in, out]``, ``b [*lead, out]``)
    chain from ``width``; returns the width they end at."""
    for w, b in stages:
        if (tuple(w.shape[:-2]) != lead or w.shape[-2] != width
                or tuple(b.shape) != lead + (w.shape[-1],)):
            raise ValueError(f"{what} stage W {tuple(w.shape)} b {tuple(b.shape)} does "
                             f"not follow width {width} with members {lead}")
        width = w.shape[-1]
    return width


def check_tensors(name: str, emb: torch.Tensor, domain_id: Optional[torch.Tensor],
                  tensors: Sequence[torch.Tensor]):
    """``emb``, ``domain_id`` and ``tensors`` on one CUDA device and
    contiguous; ``emb`` and ``tensors`` float32."""
    if emb.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {emb.device}")
    for t in [emb, *([] if domain_id is None else [domain_id]), *tensors]:
        if t.device != emb.device:
            raise ValueError(f"tensor on {t.device}, emb on {emb.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
    for t in [emb, *tensors]:
        if t.dtype != torch.float32:
            raise ValueError(f"{name} takes float32, got {t.dtype}")


def ptrs(tensors: List[Optional[torch.Tensor]]):
    """A host array of device pointers (passed to C as ``void*``); ``None``
    is a null pointer."""
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[None if t is None else t.data_ptr() for t in tensors])


def ints(values: List[int]):
    return (ctypes.c_int * max(1, len(values)))(*values)


def stage_args(stages: Sequence[Affine]):
    """The three arrays a kernel reads its stages from: W pointers, b
    pointers (``None`` for a stage without bias) and ``(K, N)`` per stage."""
    return (ptrs([w for w, _ in stages]), ptrs([b for _, b in stages]),
            ints([n for w, _ in stages for n in (w.shape[-2], w.shape[-1])]))


def mix(gate: torch.Tensor, experts: Sequence[torch.Tensor]) -> torch.Tensor:
    """``sum_e gate[:, e] * experts[e]``, in order, as the TPU kernels sum."""
    mixed = gate[:, 0:1] * experts[0]
    for e in range(1, len(experts)):
        mixed = mixed + gate[:, e:e + 1] * experts[e]
    return mixed


@functools.lru_cache(maxsize=None)
def function(source: str, symbol: str, argtypes: tuple):
    """``symbol`` of ``csrc/<source>.cu`` (built and loaded on first use), its
    arguments ``argtypes`` then ``block_rows``, the stream and a ``size_t*``
    for the shared memory a block takes; it returns a cudaError_t."""
    from . import _build

    fn = getattr(_build.load(source), symbol)
    fn.argtypes = list(argtypes) + [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    return fn


def launch(source: str, symbol: str, argtypes: tuple, args: tuple, emb: torch.Tensor,
           block_rows: int) -> None:
    """Calls ``symbol`` of ``csrc/<source>.cu`` with ``args``, then
    ``block_rows``, the current stream and the shared-memory report, on
    ``emb``'s device; raises if the launch fails."""
    fn = function(source, symbol, argtypes)
    smem = ctypes.c_size_t(0)
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    with torch.cuda.device(emb.device):
        err = fn(*args, block_rows, stream, ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(
            f"{symbol} launch failed with cudaError {err} ({smem.value} bytes of "
            f"shared memory per block, block_rows={block_rows})")
