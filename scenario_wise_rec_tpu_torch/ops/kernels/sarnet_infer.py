"""Fused SAR-Net inference: the CUDA kernel ``csrc/sarnet_infer.cu`` and its
plain PyTorch version.

SAR-Net's eval forward after the embedding: each domain's elementwise
scale and shift of the embedding, the shared debias experts on the row's
own domain's scaled embedding and every domain's specific experts on its
own, selected per row, a softmax gate over the experts, the gate-weighted
mixture, the final relu MLP, its head and the sigmoid. The debias experts
(BatchNorm -> Linear) come folded to affines (``folding.py``). The kernel
gives each block rows of one domain and runs only that domain's specific
experts, the experts and the gate as one product on the tensor cores in
3xTF32 (about f32's accuracy), the weights streamed through shared memory
(the design note is at the top of the source). It replaces the TPU kernel
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
from .mmoe_infer import check_block_rows

MAX_DOMAINS = 256  # csrc kMaxDomains: the partition's counts in shared memory
MAX_FINAL = 31     # csrc kMaxSteps - 1: final stages a launch (the experts' product is one)
MAX_COLUMNS = 256  # csrc kChunk: the experts' and the gate's columns, each padded to 8


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


def _columns(n_sh: int, n_sp: int, H: int) -> int:
    """Columns of the kernel's one product of the experts and the gate:
    each expert's H and the gate's n_sh + n_sp, each rounded up to 8."""
    return (n_sh + n_sp) * (-(-H // 8) * 8) + -(-(n_sh + n_sp) // 8) * 8


def check_card_limits(D: int, n_sh: int, n_sp: int, H: int, n_fin: int) -> None:
    """What the card takes beyond the tile rule: at most ``MAX_DOMAINS``
    domains, ``MAX_COLUMNS`` columns of experts and gate side by side (at
    H 16, 15 experts) and ``MAX_FINAL`` final stages."""
    if D > MAX_DOMAINS:
        raise ValueError(f"sarnet_fused_infer takes at most {MAX_DOMAINS} domains, got {D}")
    cols = _columns(n_sh, n_sp, H)
    if cols > MAX_COLUMNS:
        raise ValueError(f"sarnet_fused_infer takes at most {MAX_COLUMNS} columns of experts "
                         f"and gate, got {cols} ({n_sh} + {n_sp} experts of width {H})")
    if n_fin > MAX_FINAL:
        raise ValueError(f"sarnet_fused_infer takes at most {MAX_FINAL} final stages, "
                         f"got {n_fin}")


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
    block_rows: int | None = None,
) -> torch.Tensor:
    """probs[B] = fused SAR-Net eval forward on the embedded batch ``emb``.

    ``block_rows``: rows of one domain that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit (at SAR-Net's Ali-CCP widths every tile fits; at
    KuaiRand's, F 796, 64 rows do not). A shape whose tile does not fit
    raises a RuntimeError; it never falls back. On the CPU the plain
    version runs and the value only has to keep the tile rule, so that a
    call that would raise on the card for its ``block_rows`` raises there
    too. The card takes at most ``MAX_DOMAINS`` domains, ``MAX_COLUMNS``
    columns of experts and gate and ``MAX_FINAL`` final stages. int32 and
    int64 domain ids are read as they are.
    """
    check_block_rows(block_rows)
    args = (emb, domain_id, dom_w, dom_b, shared_lin, spec_lin, gate, final_stages, final_out)
    if emb.device.type == "cpu":
        return sarnet_fused_infer_ref(*args)
    B, F, D, n_sh, n_sp = _check_shapes(*args)
    H = shared_lin[0].shape[-1]
    check_card_limits(D, n_sh, n_sp, H, len(final_stages))
    stages = [shared_lin, spec_lin, gate] + list(final_stages) + [final_out]
    _fused.check_tensors("sarnet_fused_infer", emb, domain_id,
                         [dom_w, dom_b] + [t for s in stages for t in s])
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    did = domain_id if domain_id.dtype in (torch.int32, torch.int64) else \
        domain_id.to(torch.int32)
    p, i = ctypes.c_void_p, ctypes.c_int
    _fused.launch(
        "sarnet_infer", "sarnet_fused_infer_f32", (p, p, i, p, p, p, i, i, i, i, i, i, p, p, p),
        (emb.data_ptr(), did.data_ptr(), did.dtype == torch.int64, out.data_ptr(),
         dom_w.data_ptr(), dom_b.data_ptr(), B, F, D, n_sh, n_sp, len(final_stages),
         *_fused.stage_args(stages)),
        emb, block_rows or 0)
    sarnet_fused_infer.launches += 1
    return out


sarnet_fused_infer.launches = 0
