"""Fused AdaptDHM inference: the CUDA kernel ``csrc/adaptdhm_infer.cu`` and
its plain PyTorch version.

AdaptDHM's eval forward after the embedding and the routing: the routed
cluster's FCN, each stage ``W_shared ⊙ W_cluster`` stacked to ``[C, in,
out]`` with no bias, relu after every stage but the last, which has width 1
and takes the sigmoid. The router (the argmax of each row's logits against
the frozen centers) is computed outside, as in the JAX package; ids are
clipped to ``[0, C-1]``. The kernel computes only the row's own cluster (the
design note is at the top of the source). It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/adaptdhm_infer.py:adaptdhm_fused_infer``.

:func:`adaptdhm_fused_infer` takes the plain version for a tensor on the CPU
and launches the kernel for one on a CUDA device, or raises; it never falls
back. ``adaptdhm_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _fused


def _check_shapes(emb, router, stages):
    B, F = _fused.check_batch(emb, router)
    if not stages:
        raise ValueError("need at least one stage")
    C, width = stages[0].shape[0], F
    for w in stages:
        if w.ndim != 3 or w.shape[0] != C or w.shape[1] != width:
            raise ValueError(f"stage W {tuple(w.shape)} does not follow width {width} "
                             f"with {C} clusters")
        width = w.shape[2]
    if width != 1:
        raise ValueError("the last stage must have width 1")
    return B, F, C


def adaptdhm_fused_infer_ref(
    emb: torch.Tensor,               # [B, F]
    router: torch.Tensor,            # [B] cluster ids
    stages: Sequence[torch.Tensor],  # each W [C, in, out], no bias
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: a loop over the clusters with
    ``@`` and a select of each row's cluster."""
    _, _, C = _check_shapes(emb, router, stages)
    rid = torch.clamp(router.to(torch.int32).long(), 0, C - 1)
    out = torch.zeros(emb.shape[0], dtype=torch.float32, device=emb.device)
    for c in range(C):
        h = emb
        for w in stages[:-1]:
            h = torch.relu(h @ w[c])
        out = torch.where(rid == c, torch.sigmoid(h @ stages[-1][c])[:, 0], out)
    return out


def adaptdhm_fused_infer(
    emb: torch.Tensor,
    router: torch.Tensor,
    stages: Sequence[torch.Tensor],
    block_rows: int = _fused.DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """probs[B] = the routed cluster's FCN on the embedded batch ``emb``.

    ``block_rows``: rows one thread block owns on the card (a multiple of 8
    up to 64). It has no effect on the CPU, where the plain version runs.
    """
    if emb.device.type == "cpu":
        return adaptdhm_fused_infer_ref(emb, router, stages)
    B, F, C = _check_shapes(emb, router, stages)
    _fused.check_launch("adaptdhm_fused_infer", emb, router, list(stages), len(stages),
                        block_rows)
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    rid = router.to(torch.int32).contiguous()
    p, i = ctypes.c_void_p, ctypes.c_int
    _fused.launch(
        "adaptdhm_infer", "adaptdhm_fused_infer_f32", (p, p, p, i, i, i, i, p, p, p),
        (emb.data_ptr(), rid.data_ptr(), out.data_ptr(), B, F, C, len(stages),
         *_fused.stage_args([(w, None) for w in stages])),
        emb, block_rows)
    adaptdhm_fused_infer.launches += 1
    return out


adaptdhm_fused_infer.launches = 0


def adaptdhm_route_margin(emb: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Each row's gap between its two largest routing logits ``emb @
    center.T`` (``[B]``; infinite with one cluster). Where it lies within
    rounding, two paths that round the logits differently may route the
    row to different clusters."""
    logits = emb @ center.T
    if logits.shape[1] < 2:
        return torch.full((emb.shape[0],), float("inf"), device=emb.device)
    top = torch.topk(logits, 2, dim=1).values
    return top[:, 0] - top[:, 1]
