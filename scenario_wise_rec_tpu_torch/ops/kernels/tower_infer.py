"""Fused "shared trunk → per-domain towers → select" inference: the CUDA
kernel ``csrc/tower_infer.cu`` and its plain PyTorch version.

SharedBottom's eval forward after the embedding: a relu trunk of shared
affine stages, D relu towers, an optional 1-unit head per domain, sigmoid,
and each row's own domain selected. The kernel runs it for a tile of rows
on chip and computes only the row's own tower (the design note is at the
top of the source). It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/tower_infer.py:trunk_towers_fused_infer``.

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
    block_rows: int = _fused.DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """probs[B] = fused trunk → towers → select on the embedded batch.

    ``block_rows``: rows one thread block owns on the card (a multiple of 8
    up to 64). It has no effect on the CPU, where the plain version runs.
    """
    if emb.device.type == "cpu":
        return trunk_towers_fused_infer_ref(emb, domain_id, trunk_stages,
                                            tower_stages, tower_out)
    B, F, D = _check_shapes(emb, domain_id, trunk_stages, tower_stages, tower_out)
    stages = list(trunk_stages) + list(tower_stages) + (
        [tower_out] if tower_out is not None else [])
    _fused.check_launch("trunk_towers_fused_infer", emb, domain_id,
                        [t for s in stages for t in s], len(stages), block_rows)
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    did = domain_id.to(torch.int32).contiguous()
    p, i = ctypes.c_void_p, ctypes.c_int
    _fused.launch(
        "tower_infer", "tower_fused_infer_f32", (p, p, p, i, i, i, i, i, i, p, p, p),
        (emb.data_ptr(), did.data_ptr(), out.data_ptr(), B, F, D, len(trunk_stages),
         len(tower_stages), int(tower_out is not None), *_fused.stage_args(stages)),
        emb, block_rows)
    trunk_towers_fused_infer.launches += 1
    return out


trunk_towers_fused_infer.launches = 0
