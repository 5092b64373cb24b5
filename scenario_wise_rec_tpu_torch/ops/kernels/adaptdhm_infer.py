"""Fused AdaptDHM inference: SharedBottom's chain kernel
``csrc/tower_infer.cu`` without a trunk and without biases, and its plain
PyTorch version.

AdaptDHM's eval forward after the embedding and the routing: the routed
cluster's FCN, each stage ``W_shared ⊙ W_cluster`` stacked to ``[C, in,
out]`` with no bias, relu after every stage but the last, which has width 1
and takes the sigmoid. The router (the argmax of each row's logits against
the frozen centers) is computed outside, as in the JAX package; ids are
taken modulo 2^32 as int32 and clipped to ``[0, C-1]``. The kernel gives
each block rows of one cluster, partitioned inside the one launch from the
int64 or int32 router ids, computes only that cluster's stages, and runs
every product on the tensor cores in 3xTF32 (about f32's accuracy), the
weights streamed through shared memory (the design note is at the top of
the source). It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/adaptdhm_infer.py:adaptdhm_fused_infer``.

:func:`adaptdhm_fused_infer` takes the plain version for a tensor on the CPU
and launches the kernel for one on a CUDA device, or raises; it never falls
back. ``adaptdhm_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _fused
from .mmoe_infer import check_block_rows
from .tower_infer import _launch_chain, check_card_limits


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
    block_rows: int | None = None,
) -> torch.Tensor:
    """probs[B] = the routed cluster's FCN on the embedded batch ``emb``.

    ``block_rows``: rows of one cluster that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit (at AdaptDHM's Ali-CCP widths 16, 32, 48 and 64 fit; at
    KuaiRand's 64 does not). A shape whose tile does not fit raises a
    RuntimeError; it never falls back. On the CPU the plain version runs and
    the value only has to keep the tile rule, so that a call that would
    raise on the card for its ``block_rows`` raises there too. The card
    takes at most ``MAX_STAGES`` (96) stages and ``MAX_DOMAINS`` (256)
    clusters. int32 and int64 router ids are read as they are.
    """
    check_block_rows(block_rows)
    if emb.device.type == "cpu":
        return adaptdhm_fused_infer_ref(emb, router, stages)
    _, _, C = _check_shapes(emb, router, stages)
    check_card_limits(len(stages), C, "adaptdhm_fused_infer", "clusters")
    _fused.check_tensors("adaptdhm_fused_infer", emb, router, list(stages))
    # no trunk: every stage is the cluster's, the last the unrelu'd head
    return _launch_chain(adaptdhm_fused_infer, "tower_fused_infer_f32", emb, router, C,
                         (0, len(stages) - 1, 1), (), [(w, None) for w in stages], block_rows)


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
