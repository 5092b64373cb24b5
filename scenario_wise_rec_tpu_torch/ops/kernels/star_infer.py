"""Fused STAR inference: SharedBottom's chain kernel ``csrc/tower_infer.cu``
run as two chains with the domain norm between them, and its plain PyTorch
version.

STAR's eval forward after the embedding: the domain norm with the batch's
mean and rstd (reduced outside the kernel, the padded rows masked out) and
each domain's gamma and beta, the domain's FCN (``W_shared ⊙ W_d`` with its
BatchNorm folded) with a relu after every stage, the width-1 one included,
an aux relu MLP on the raw embedding whose logit is added, the sigmoid, and
each row's own domain selected; ids are taken modulo 2^32 as int32 and
clipped to ``[0, D-1]``. The kernel gives each block rows of one domain,
partitioned inside the one launch from the int64 or int32 ids, runs the aux
MLP and its head, then the norm over the block's tile in place, then only
that domain's FCN, every product on the tensor cores in 3xTF32 (about f32's
accuracy), the weights streamed through shared memory (the design note is
at the top of the source). It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/star_infer.py:star_fused_infer``.

:func:`star_fused_infer` takes the plain version for a tensor on the CPU
and launches the kernel for one on a CUDA device, or raises; it never falls
back. ``star_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

from typing import Sequence

import torch

from . import _fused
from ._fused import Affine
from .mmoe_infer import check_block_rows
from .tower_infer import _launch_chain, check_card_limits


def _check_shapes(emb, domain_id, mean, rstd, dn_gamma, dn_beta, fcn_stages,
                  aux_stages, aux_out):
    B, F = _fused.check_batch(emb, domain_id)
    D = dn_gamma.shape[0]
    if mean.shape != (F,) or rstd.shape != (F,):
        raise ValueError(f"mean and rstd must be [{F}]")
    if dn_gamma.shape != (D, F) or dn_beta.shape != (D, F):
        raise ValueError(f"dn_gamma and dn_beta must be [{D}, {F}]")
    if not fcn_stages:
        raise ValueError("need at least one FCN stage")
    if _fused.check_chain("fcn", fcn_stages, (D,), F) != 1:
        raise ValueError("the last FCN stage must have width 1")
    width = _fused.check_chain("aux", aux_stages, (), F)
    _fused.check_chain("aux head", [aux_out], (), width)
    if aux_out[0].shape[-1] != 1:
        raise ValueError("the aux head must have width 1")
    return B, F, D


def star_fused_infer_ref(
    emb: torch.Tensor,            # [B, F]
    domain_id: torch.Tensor,      # [B]
    mean: torch.Tensor,           # [F] batch mean of emb
    rstd: torch.Tensor,           # [F] 1/sqrt(batch var + eps)
    dn_gamma: torch.Tensor,       # [D, F] share_gamma * gamma_d
    dn_beta: torch.Tensor,        # [D, F] share_beta + beta_d
    fcn_stages: Sequence[Affine],  # each (W[D,in,out], b[D,out]), BN folded
    aux_stages: Sequence[Affine],  # each (W[in,out], b[out]), BN folded
    aux_out: Affine,               # (W[h,1], b[1])
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: the aux MLP, then a loop over D
    with the domain norm, ``@``, and a select of each row's domain."""
    _, _, D = _check_shapes(emb, domain_id, mean, rstd, dn_gamma, dn_beta,
                            fcn_stages, aux_stages, aux_out)
    a = emb
    for w, b in aux_stages:
        a = torch.relu(a @ w + b)
    a = (a @ aux_out[0] + aux_out[1])[:, 0]
    normed = (emb - mean) * rstd
    did = torch.clamp(domain_id.to(torch.int32).long(), 0, D - 1)
    out = torch.zeros(emb.shape[0], dtype=torch.float32, device=emb.device)
    for d in range(D):
        h = dn_gamma[d] * normed + dn_beta[d]
        for w, b in fcn_stages:
            h = torch.relu(h @ w[d] + b[d])  # the width-1 stage too
        out = torch.where(did == d, h[:, 0], out)
    return torch.sigmoid(out + a)


def star_fused_infer(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    mean: torch.Tensor,
    rstd: torch.Tensor,
    dn_gamma: torch.Tensor,
    dn_beta: torch.Tensor,
    fcn_stages: Sequence[Affine],
    aux_stages: Sequence[Affine],
    aux_out: Affine,
    block_rows: int | None = None,
) -> torch.Tensor:
    """probs[B] = fused STAR eval forward on the embedded batch ``emb``.

    ``block_rows``: rows of one domain that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit (at STAR's Ali-CCP widths 16, 32, 48 and 64 fit; at
    KuaiRand's 64 does not). A shape whose tile does not fit raises a
    RuntimeError; it never falls back. On the CPU the plain version runs and
    the value only has to keep the tile rule, so that a call that would
    raise on the card for its ``block_rows`` raises there too. The card
    takes at most ``MAX_STAGES`` (96) stages (the aux stages, the aux head
    and the FCN stages together) and ``MAX_DOMAINS`` (256) domains. int32
    and int64 domain ids are read as they are.
    """
    check_block_rows(block_rows)
    if emb.device.type == "cpu":
        return star_fused_infer_ref(emb, domain_id, mean, rstd, dn_gamma, dn_beta,
                                    fcn_stages, aux_stages, aux_out)
    _, _, D = _check_shapes(emb, domain_id, mean, rstd, dn_gamma, dn_beta,
                            fcn_stages, aux_stages, aux_out)
    # the chain kernel's order: the aux stages and head, then the FCN
    stages = list(aux_stages) + [aux_out] + list(fcn_stages)
    check_card_limits(len(stages), D, "star_fused_infer")
    vectors = [mean, rstd, dn_gamma, dn_beta]
    _fused.check_tensors("star_fused_infer", emb, domain_id,
                         vectors + [t for s in stages for t in s])
    return _launch_chain(star_fused_infer, "star_fused_infer_f32", emb, domain_id, D,
                         (len(aux_stages), len(fcn_stages)), vectors, stages, block_rows)


star_fused_infer.launches = 0
