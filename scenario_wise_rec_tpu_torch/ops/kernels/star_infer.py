"""Fused STAR inference: the CUDA kernel ``csrc/star_infer.cu`` and its plain
PyTorch version.

STAR's eval forward after the embedding: the domain norm with the batch's
mean and rstd (reduced outside the kernel, the padded rows masked out) and
each domain's gamma and beta, the domain's FCN (``W_shared ⊙ W_d`` with its
BatchNorm folded) with a relu after every stage, the width-1 one included,
an aux relu MLP on the raw embedding whose logit is added, the sigmoid, and
each row's own domain selected. The kernel computes only the row's own
domain (the design note is at the top of the source). It replaces the TPU
kernel ``scenario_wise_rec_tpu/ops/pallas/star_infer.py:star_fused_infer``.

:func:`star_fused_infer` takes the plain version for a tensor on the CPU
and launches the kernel for one on a CUDA device, or raises; it never falls
back. ``star_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _fused
from ._fused import Affine


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
    block_rows: int = _fused.DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """probs[B] = fused STAR eval forward on the embedded batch ``emb``.

    ``block_rows``: rows one thread block owns on the card (a multiple of 8
    up to 64). It has no effect on the CPU, where the plain version runs.
    """
    if emb.device.type == "cpu":
        return star_fused_infer_ref(emb, domain_id, mean, rstd, dn_gamma, dn_beta,
                                    fcn_stages, aux_stages, aux_out)
    B, F, D = _check_shapes(emb, domain_id, mean, rstd, dn_gamma, dn_beta,
                            fcn_stages, aux_stages, aux_out)
    stages = list(fcn_stages) + list(aux_stages) + [aux_out]
    vectors = [mean, rstd, dn_gamma, dn_beta]
    _fused.check_launch("star_fused_infer", emb, domain_id,
                        vectors + [t for s in stages for t in s], len(stages),
                        block_rows)
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    did = domain_id.to(torch.int32).contiguous()
    p, i = ctypes.c_void_p, ctypes.c_int
    _fused.launch(
        "star_infer", "star_fused_infer_f32", (p, p, p, p, p, p, p, i, i, i, i, i, p, p, p),
        (emb.data_ptr(), did.data_ptr(), out.data_ptr(), *[v.data_ptr() for v in vectors],
         B, F, D, len(fcn_stages), len(aux_stages), *_fused.stage_args(stages)),
        emb, block_rows)
    star_fused_infer.launches += 1
    return out


star_fused_infer.launches = 0
