"""Fused "shared trunk → per-domain towers → select" inference: the CUDA
kernel ``csrc/tower_infer.cu`` and its plain PyTorch version.

SharedBottom's eval forward after the embedding: a relu trunk of shared
affine stages, D relu towers, an optional 1-unit head per domain, sigmoid,
and each row's own domain selected. The kernel gives each block rows of one
domain, computes only that domain's tower, and runs every product on the
tensor cores in 3xTF32 (about f32's accuracy), the weights streamed through
shared memory (the design note is at the top of the source). It replaces the
TPU kernel
``scenario_wise_rec_tpu/ops/pallas/tower_infer.py:trunk_towers_fused_infer``.
AdaptDHM's routed FCN (``adaptdhm_infer.py``) runs on the same kernel, as a
chain without a trunk and without biases, and STAR's eval (``star_infer.py``)
as two chains, its aux MLP and its domain's FCN, with the domain norm between
them (:func:`_launch_chain`).

Preconditions: eval mode (BatchNorm folded to affine, see ``folding.py``),
relu activations. Without a head (``tower_out=None``) the last stage has
width 1, and the relu after it comes before the sigmoid, as in the TPU
kernel.

:func:`trunk_towers_fused_infer` takes the plain version for a tensor on
the CPU and launches the kernel for one on a CUDA device, or raises; it
never falls back. ``trunk_towers_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import torch

from . import _fused
from ._fused import Affine
from .mmoe_infer import ROW_TILE, check_block_rows

MAX_STAGES = 96    # csrc kMaxSteps: trunk, tower and head stages a launch
MAX_DOMAINS = 256  # csrc kMaxDomains: the partition's counts in shared memory


def _check_shapes(emb, domain_id, trunk_stages, tower_stages, tower_out):
    B, F = _fused.check_batch(emb, domain_id)
    if tower_stages:
        D = tower_stages[0][0].shape[0]
    elif tower_out is not None:
        D = tower_out[0].shape[0]
    else:
        raise ValueError("need a tower stage or a head")
    width = _fused.check_chain("trunk", trunk_stages, (), F)
    width = _fused.check_chain("tower", tower_stages, (D,), width)
    if tower_out is not None:
        width = _fused.check_chain("head", [tower_out], (D,), width)
    if width != 1:
        raise ValueError(f"the towers end at width {width}: without a head "
                         "the last tower stage must have width 1")
    return B, F, D


def check_card_limits(n_stages: int, D: int, name: str = "trunk_towers_fused_infer",
                      members: str = "domains") -> None:
    """What the card takes beyond the tile rule: at most ``MAX_STAGES``
    stages (trunk, towers and head together) and ``MAX_DOMAINS`` domains
    (AdaptDHM's clusters)."""
    if n_stages > MAX_STAGES:
        raise ValueError(f"{name} takes at most {MAX_STAGES} stages, got {n_stages}")
    if D > MAX_DOMAINS:
        raise ValueError(f"{name} takes at most {MAX_DOMAINS} {members}, got {D}")


def trunk_towers_fused_infer_ref(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    trunk_stages: Sequence[Affine],    # each (W[in,out], b[out])
    tower_stages: Sequence[Affine],    # each (W[D,in,out], b[D,out])
    tower_out: Optional[Affine],       # (W[D,h,1], b[D,1]) or None
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: the trunk with ``@``, then a loop
    over D with ``@``, sigmoid and a select of each row's domain."""
    _, _, D = _check_shapes(emb, domain_id, trunk_stages, tower_stages, tower_out)
    h = emb
    for w, b in trunk_stages:
        h = torch.relu(h @ w + b)
    did = torch.clamp(domain_id.to(torch.int32).long(), 0, D - 1)
    out = torch.zeros(emb.shape[0], dtype=torch.float32, device=emb.device)
    for d in range(D):
        t = h
        for w, b in tower_stages:
            t = torch.relu(t @ w[d] + b[d])
        if tower_out is not None:
            t = t @ tower_out[0][d] + tower_out[1][d]
        out = torch.where(did == d, torch.sigmoid(t[:, 0]), out)
    return out


def trunk_towers_fused_infer(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    trunk_stages: Sequence[Affine],
    tower_stages: Sequence[Affine],
    tower_out: Optional[Affine],
    block_rows: int | None = None,
) -> torch.Tensor:
    """probs[B] = fused trunk → towers → select on the embedded batch.

    ``block_rows``: rows of one domain that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit (at SharedBottom's Ali-CCP widths 16, 32 and 48 fit; 64
    does not). A shape whose tile does not fit raises a RuntimeError; it
    never falls back. On the CPU the plain version runs and the value only
    has to keep the tile rule, so that a call that would raise on the card
    for its ``block_rows`` raises there too. The card takes at most
    ``MAX_STAGES`` stages (trunk, towers and head together) and
    ``MAX_DOMAINS`` domains. int32 and int64 domain ids are read as they
    are.
    """
    check_block_rows(block_rows)
    if emb.device.type == "cpu":
        return trunk_towers_fused_infer_ref(emb, domain_id, trunk_stages,
                                            tower_stages, tower_out)
    B, F, D = _check_shapes(emb, domain_id, trunk_stages, tower_stages, tower_out)
    stages = list(trunk_stages) + list(tower_stages) + (
        [tower_out] if tower_out is not None else [])
    check_card_limits(len(stages), D)
    _fused.check_tensors("trunk_towers_fused_infer", emb, domain_id,
                         [t for s in stages for t in s])
    return _launch_chain(trunk_towers_fused_infer, "tower_fused_infer_f32", emb, domain_id, D,
                         (len(trunk_stages), len(tower_stages), int(tower_out is not None)),
                         (), stages, block_rows)


def _launch_chain(wrapper, symbol, emb, domain_id, D, counts, tensors, stages, block_rows):
    """probs[B] from one launch of ``symbol`` of ``csrc/tower_infer.cu``, the
    chain kernel: its arguments emb, the ids (int32 or int64 as they are),
    out, B, F, D, then the entry's ``counts`` (ints) and ``tensors``, then
    the stages' arrays (each stage ``(W, b)``, ``b`` None for a stage
    without bias). Adds one to ``wrapper.launches`` where it launches;
    raises a RuntimeError, naming ``wrapper``, if the launch fails."""
    B, F = emb.shape
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    did = domain_id if domain_id.dtype in (torch.int32, torch.int64) else \
        domain_id.to(torch.int32)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _fused.function("tower_infer", symbol,
                         (p, p, i, p, i, i, i) + (i,) * len(counts) + (p,) * len(tensors)
                         + (p, p, p))
    smem = ctypes.c_size_t(0)
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    with torch.cuda.device(emb.device):
        err = fn(emb.data_ptr(), did.data_ptr(), did.dtype == torch.int64, out.data_ptr(), B,
                 F, D, *counts, *[t.data_ptr() for t in tensors], *_fused.stage_args(stages),
                 block_rows or 0, stream, ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(
            f"{wrapper.__name__} launch failed with cudaError {err} ({smem.value} bytes of "
            f"shared memory per block, block_rows={block_rows or ROW_TILE})")
    wrapper.launches += 1
    return out


trunk_towers_fused_infer.launches = 0
