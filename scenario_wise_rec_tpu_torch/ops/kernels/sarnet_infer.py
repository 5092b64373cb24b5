"""Fused SAR-Net inference: the CUDA kernel ``csrc/sarnet_infer.cu`` and its
plain PyTorch version.

SAR-Net's eval forward after the embedding: each domain's elementwise
scale and shift of the embedding, the shared debias experts on the row's
own domain's scaled embedding and every domain's specific experts on its
own, selected per row, a softmax gate over the experts, the gate-weighted
mixture, the final relu MLP, its head and the sigmoid. The debias experts
(BatchNorm -> Linear) come folded to affines (``folding.py``). The kernel
runs only each row's own domain's specific experts (the design note is at
the top of the source). It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/sarnet_infer.py:sarnet_fused_infer``.

:func:`sarnet_fused_infer` takes the plain version for a tensor on the CPU
and launches the kernel for one on a CUDA device, or raises; it never falls
back. ``sarnet_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _fused
from ._fused import Affine


def _check_shapes(emb, domain_id, dom_w, dom_b, shared_lin, spec_lin, gate,
                  final_stages, final_out):
    B, F = _fused.check_batch(emb, domain_id)
    D = dom_w.shape[0]
    if dom_w.shape != (D, F) or dom_b.shape != (D, F):
        raise ValueError(f"dom_w and dom_b must be [D, {F}], got {tuple(dom_w.shape)} "
                         f"and {tuple(dom_b.shape)}")
    if shared_lin[0].ndim != 3 or spec_lin[0].ndim != 4 or spec_lin[0].shape[0] != D:
        raise ValueError("shared experts must be W [n_sh, F, H], specific ones "
                         f"W [{D}, n_sp, F, H]")
    n_sh, n_sp = shared_lin[0].shape[0], spec_lin[0].shape[1]
    h = _fused.check_chain("shared experts", [shared_lin], (n_sh,), F)
    if _fused.check_chain("specific experts", [spec_lin], (D, n_sp), F) != h:
        raise ValueError(f"specific experts must end at width {h}")
    if _fused.check_chain("gate", [gate], (), F) != n_sh + n_sp:
        raise ValueError(f"the gate must end at width {n_sh + n_sp}")
    width = _fused.check_chain("final", final_stages, (), h)
    _fused.check_chain("head", [final_out], (), width)
    if final_out[0].shape[-1] != 1:
        raise ValueError("the head must have width 1")
    return B, F, D, n_sh, n_sp


def sarnet_fused_infer_ref(
    emb: torch.Tensor,                 # [B, F]
    domain_id: torch.Tensor,           # [B]
    dom_w: torch.Tensor,               # [D, F] elementwise scale
    dom_b: torch.Tensor,               # [D, F] elementwise shift
    shared_lin: Affine,                # (W[n_sh, F, H], b[n_sh, H]) folded
    spec_lin: Affine,                  # (W[D, n_sp, F, H], b[D, n_sp, H]) folded
    gate: Affine,                      # (W[F, n_sh + n_sp], b[n_sh + n_sp])
    final_stages: Sequence[Affine],    # each (W[in, out], b[out]) folded
    final_out: Affine,                 # (W[h, 1], b[1])
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: every domain's scaled embedding
    and specific experts with ``@``, a select of each row's domain (the TPU
    kernel's loops), the shared experts and the gate on the selected row."""
    _, _, D, n_sh, n_sp = _check_shapes(emb, domain_id, dom_w, dom_b, shared_lin,
                                        spec_lin, gate, final_stages, final_out)
    did = torch.clamp(domain_id.to(torch.int32).long(), 0, D - 1)[:, None]
    scaled = [emb * dom_w[d] + dom_b[d] for d in range(D)]
    sel = scaled[0]
    for d in range(1, D):
        sel = torch.where(did == d, scaled[d], sel)
    shw, shb = shared_lin
    spw, spb = spec_lin
    experts = [sel @ shw[e] + shb[e] for e in range(n_sh)]
    for j in range(n_sp):
        sj = scaled[0] @ spw[0, j] + spb[0, j]
        for d in range(1, D):
            sj = torch.where(did == d, scaled[d] @ spw[d, j] + spb[d, j], sj)
        experts.append(sj)
    g = torch.softmax(sel @ gate[0] + gate[1], dim=1)
    h = _fused.mix(g, experts)
    for w, b in final_stages:
        h = torch.relu(h @ w + b)
    return torch.sigmoid(h @ final_out[0] + final_out[1])[:, 0]


def sarnet_fused_infer(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    dom_w: torch.Tensor,
    dom_b: torch.Tensor,
    shared_lin: Affine,
    spec_lin: Affine,
    gate: Affine,
    final_stages: Sequence[Affine],
    final_out: Affine,
    block_rows: int = _fused.DEFAULT_BLOCK_ROWS,
) -> torch.Tensor:
    """probs[B] = fused SAR-Net eval forward on the embedded batch ``emb``.

    ``block_rows``: rows one thread block owns on the card (a multiple of 8
    up to 64). It has no effect on the CPU, where the plain version runs.
    """
    if emb.device.type == "cpu":
        return sarnet_fused_infer_ref(emb, domain_id, dom_w, dom_b, shared_lin, spec_lin,
                                      gate, final_stages, final_out)
    B, F, D, n_sh, n_sp = _check_shapes(emb, domain_id, dom_w, dom_b, shared_lin, spec_lin,
                                        gate, final_stages, final_out)
    stages = [shared_lin, spec_lin, gate] + list(final_stages) + [final_out]
    _fused.check_launch("sarnet_fused_infer", emb, domain_id,
                        [dom_w, dom_b] + [t for s in stages for t in s], len(stages),
                        block_rows)
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    did = domain_id.to(torch.int32).contiguous()
    p, i = ctypes.c_void_p, ctypes.c_int
    _fused.launch(
        "sarnet_infer", "sarnet_fused_infer_f32", (p, p, p, p, p, i, i, i, i, i, i, p, p, p),
        (emb.data_ptr(), did.data_ptr(), out.data_ptr(), dom_w.data_ptr(), dom_b.data_ptr(),
         B, F, D, n_sh, n_sp, len(final_stages), *_fused.stage_args(stages)),
        emb, block_rows)
    sarnet_fused_infer.launches += 1
    return out


sarnet_fused_infer.launches = 0
