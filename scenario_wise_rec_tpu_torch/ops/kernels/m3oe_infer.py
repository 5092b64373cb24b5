"""Fused M3oE inference: the CUDA kernel ``csrc/m3oe_infer.cu`` and its
plain PyTorch version.

M3oE's eval forward after the embedding is all per row (LayerNorm, no
batch statistics): the STAR-style slot of the row's domain and the skip
``Mlp_N``, the star ``Mlp_N``, the shared and the domain ``Mlp_N`` experts,
the softmax gate, the cross-domain balance mix, the expert fusion, the
tower (Linear → LayerNorm → relu → Linear), the sigmoid and the select of
each row's domain. The kernel gives each block rows of one domain and runs
every product on the tensor cores in 3xTF32 (about f32's accuracy), the
weights streamed through shared memory (the design note is at the top of
the source). It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/m3oe_infer.py:m3oe_fused_infer``.

Weights, stacked on a leading member axis where the TPU kernel stacks them
(``models/m3oe.py:fold_eval`` builds them):

- ``star``: ``(W[D, s0, s1], b[D, s1])``, ``slot_w ⊙ shared_w`` and
  ``slot_b + shared_b``;
- ``skip``, ``star_mlp``: ``Mlp_N`` layers ``(W[in, out], b[out],
  gamma[out], beta[out])``;
- ``experts``: the same stacked on E; ``domain_experts`` stacked on D;
- ``gates``: ``(W[D, s2, E], b[D, E])``; ``towers``: ``(l1w[D, h, h],
  l1b[D, h], gamma[D, h], beta[D, h], l2w[D, h, 1], l2b[D, 1])``;
- ``w_exp``, ``w_bal``: ``[1]`` tensors, ``sigmoid(w_exp_d)`` and
  ``sigmoid(w_bal_d)``; the balance coefficients follow from ``w_bal``.

:func:`m3oe_fused_infer` takes the plain version for a tensor on the CPU
and launches the kernel for one on a CUDA device, or raises; it never falls
back. ``m3oe_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence, Tuple

import torch

from ..nn import layernorm
from . import _fused
from .mmoe_infer import ROW_TILE, check_block_rows

# (lin_w, lin_b, ln_gamma, ln_beta), possibly stacked on a member axis
MlpNLayer = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

MAX_PRODUCTS = 48  # csrc kMaxSteps: the step list is a kernel parameter


def _check_mlp_n(what, layers, lead, width):
    """Checks ``Mlp_N`` layers from ``width``; returns the width they end at."""
    for i, layer in enumerate(layers):
        if len(layer) != 4:
            raise ValueError(f"{what} layer {i} must be (w, b, gamma, beta)")
        w, b, g, be = layer
        out = _fused.check_chain(f"{what} layer {i}", [(w, b)], lead, width)
        if tuple(g.shape) != lead + (out,) or tuple(be.shape) != lead + (out,):
            raise ValueError(f"{what} layer {i}: gamma {tuple(g.shape)} beta "
                             f"{tuple(be.shape)}, want {lead + (out,)}")
        width = out
    return width


def _check_shapes(emb, domain_id, star, skip, star_mlp, gates, experts, domain_experts,
                  towers, w_exp, w_bal):
    """``(B, s0, D, E)``; raises on weights that do not chain."""
    B, s0 = _fused.check_batch(emb, domain_id)
    D = star[0].shape[0]
    if not experts or not domain_experts or not star_mlp or not skip:
        raise ValueError("need skip, star MLP, expert and domain expert layers")
    E = experts[0][0].shape[0]
    s1 = _fused.check_chain("star", [star], (D,), s0)
    s2 = _check_mlp_n("skip", skip, (), s0)
    if _check_mlp_n("star_mlp", star_mlp, (), s1) != s2:
        raise ValueError(f"the star MLP must end at the skip's width {s2}")
    h = _check_mlp_n("experts", experts, (E,), s2)
    if _check_mlp_n("domain experts", domain_experts, (D,), s2) != h:
        raise ValueError(f"the domain experts must end at the experts' width {h}")
    if _fused.check_chain("gates", [gates], (D,), s2) != E:
        raise ValueError(f"the gates must end at the expert count {E}")
    if len(towers) != 6:
        raise ValueError("towers must be (l1w, l1b, gamma, beta, l2w, l2b)")
    t = _check_mlp_n("tower", [towers[:4]], (D,), h)
    if _fused.check_chain("tower head", [towers[4:]], (D,), t) != 1:
        raise ValueError("the tower head must have width 1")
    for name, s in (("w_exp", w_exp), ("w_bal", w_bal)):
        if s.numel() != 1:
            raise ValueError(f"{name} must hold one value, got {tuple(s.shape)}")
    return B, s0, D, E


def m3oe_fused_infer_ref(
    emb: torch.Tensor,                   # [B, s0]
    domain_id: torch.Tensor,             # [B]
    star: Tuple[torch.Tensor, torch.Tensor],   # (W[D, s0, s1], b[D, s1])
    skip: Sequence[MlpNLayer],
    star_mlp: Sequence[MlpNLayer],
    gates: Tuple[torch.Tensor, torch.Tensor],  # (W[D, s2, E], b[D, E])
    experts: Sequence[MlpNLayer],              # stacked on E
    domain_experts: Sequence[MlpNLayer],       # stacked on D
    towers: Tuple[torch.Tensor, ...],
    w_exp: torch.Tensor,                 # [1], sigmoid(w_exp_d)
    w_bal: torch.Tensor,                 # [1], sigmoid(w_bal_d)
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: the TPU kernel's loops (every
    domain's slot, gate and tower, each row's own selected)."""
    _, _, D, E = _check_shapes(emb, domain_id, star, skip, star_mlp, gates, experts,
                               domain_experts, towers, w_exp, w_bal)
    did = torch.clamp(domain_id.to(torch.int32).long(), 0, D - 1)[:, None]

    def mlp_n(h, layers, member=None):
        for w, b, g, be in layers:
            if member is not None:
                w, b, g, be = w[member], b[member], g[member], be[member]
            h = torch.relu(layernorm(h @ w + b, g, be))
        return h

    s = mlp_n(emb, skip)
    sel = torch.zeros(emb.shape[0], star[0].shape[-1], dtype=emb.dtype, device=emb.device)
    for d in range(D):
        sel = torch.where(did == d, emb @ star[0][d] + star[1][d], sel)
    e = mlp_n(sel, star_mlp) + s
    fea = [mlp_n(e, experts, i) for i in range(E)]
    dom = [mlp_n(e, domain_experts, d) for d in range(D)]
    total = dom[0]
    for d in range(1, D):
        total = total + dom[d]
    w_exp, w_bal = w_exp.reshape(()), w_bal.reshape(())
    off = (1.0 - w_bal) / (D - 1) if D > 1 else None
    l1w, l1b, tg, tbe, l2w, l2b = towers
    out = torch.zeros(emb.shape[0], 1, dtype=emb.dtype, device=emb.device)
    for d in range(D):
        g = torch.softmax(e @ gates[0][d] + gates[1][d], dim=1)  # [B, E]
        mixed = g[:, 0:1] * fea[0]
        for i in range(1, E):
            mixed = mixed + g[:, i:i + 1] * fea[i]
        weighted = (w_bal - off) * dom[d] + off * total if D > 1 else w_bal * dom[d]
        t = torch.relu(layernorm((mixed + w_exp * weighted) @ l1w[d] + l1b[d], tg[d], tbe[d]))
        out = torch.where(did == d, torch.sigmoid(t @ l2w[d] + l2b[d]), out)
    return out[:, 0]


def m3oe_fused_infer(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    star: Tuple[torch.Tensor, torch.Tensor],
    skip: Sequence[MlpNLayer],
    star_mlp: Sequence[MlpNLayer],
    gates: Tuple[torch.Tensor, torch.Tensor],
    experts: Sequence[MlpNLayer],
    domain_experts: Sequence[MlpNLayer],
    towers: Tuple[torch.Tensor, ...],
    w_exp: torch.Tensor,
    w_bal: torch.Tensor,
    block_rows: int | None = None,
) -> torch.Tensor:
    """probs[B] = fused M3oE eval forward on the embedded batch ``emb``.

    ``block_rows``: rows of one domain that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit (at M3oE's Ali-CCP widths 16 and 32 fit, 48 and 64 do
    not). A shape whose tile does not fit raises a RuntimeError; it never
    falls back. On the CPU the plain version runs and the value only has to
    keep the tile rule, so that a call that would raise on the card for its
    ``block_rows`` raises there too. The card takes at most
    ``MAX_PRODUCTS`` products: the layers of the skip and star MLP chains,
    of the E shared and the D domain expert chains, the star slot, the gate
    and the tower's first Linear (so at most 43 domains). int32 and int64
    domain ids are read as they are.
    """
    check_block_rows(block_rows)
    args = (emb, domain_id, star, skip, star_mlp, gates, experts, domain_experts, towers,
            w_exp, w_bal)
    if emb.device.type == "cpu":
        return m3oe_fused_infer_ref(*args)
    B, s0, D, E = _check_shapes(*args)
    chains = [skip, star_mlp, experts, domain_experts]
    products = len(skip) + len(star_mlp) + E * len(experts) + D * len(domain_experts) + 3
    if products > MAX_PRODUCTS:
        raise ValueError(f"m3oe_fused_infer takes at most {MAX_PRODUCTS} products a launch, "
                         f"got {products}")
    # every stage as (w, b, gamma, beta): the star and the gate and the tower
    # head have no norm
    stages = ([(star[0], star[1], None, None)] + [tuple(l) for c in chains for l in c]
              + [(gates[0], gates[1], None, None), tuple(towers[:4]),
                 (towers[4], towers[5], None, None)])
    tensors = [t for s in stages for t in s if t is not None]
    _fused.check_tensors("m3oe_fused_infer", emb, domain_id, tensors + [w_exp, w_bal])
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    did = domain_id if domain_id.dtype in (torch.int32, torch.int64) else \
        domain_id.to(torch.int32)
    w_ptrs, b_ptrs, dims = _fused.stage_args([s[:2] for s in stages])
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _fused.function("m3oe_infer", "m3oe_fused_infer_f32",
                         (p, p, i, p, i, i, i, i, p, p, p, p, p, p, p, p))
    smem = ctypes.c_size_t(0)
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    with torch.cuda.device(emb.device):
        err = fn(emb.data_ptr(), did.data_ptr(), did.dtype == torch.int64, out.data_ptr(), B,
                 s0, D, E, _fused.ints([len(c) for c in chains]), w_ptrs, b_ptrs,
                 _fused.ptrs([s[2] for s in stages]), _fused.ptrs([s[3] for s in stages]),
                 dims, w_exp.data_ptr(), w_bal.data_ptr(), block_rows or 0, stream,
                 ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(
            f"m3oe_fused_infer launch failed with cudaError {err} ({smem.value} bytes of "
            f"shared memory per block, block_rows={block_rows or ROW_TILE})")
    m3oe_fused_infer.launches += 1
    return out


m3oe_fused_infer.launches = 0
