"""Fused M2M inference after the transformer: the CUDA kernel
``csrc/m2m_infer.cu`` and its plain PyTorch version.

M2M's one batch-global stage, the transformer over the batch as a
sequence, stays in PyTorch. Everything after it is per row: the leakyrelu
experts on the transformer output, the scenario and task hyper-MLPs on the
scenario embedding, the meta-attention whose per-row ``[2E, 2E]`` matrix and
bias are generated from the scenario embedding, the softmax over the
experts, the meta-tower with its generated ``[E, E]`` matrix, bias and
residual, the relu output MLP, its head and the sigmoid. It replaces the TPU
kernel ``scenario_wise_rec_tpu/ops/pallas/m2m_infer.py:m2m_fused_infer``.

Each row's generated matrices are used as flat generator outputs: row ``e``
of the meta matrix is ``vw[:, e·2E:(e+1)·2E]``, of the tower matrix
``tw[:, e·E:(e+1)·E]``. The kernel gives each block a tile of consecutive
rows and runs every product with shared weights on the tensor cores in
3xTF32 (about f32's accuracy): the experts' first stage as one product of
all experts side by side, and ``vw``'s and ``tw``'s last stages a chunk of
256 columns at a time, each chunk added into the row's meta sums (or the
tower's input) before the next, so that no generated matrix is ever whole
in shared memory (the design note is at the top of the source).

Preconditions: eval mode (BatchNorm folded to affine, see ``folding.py``),
leakyrelu(0.1) experts and hyper-MLPs, a relu output MLP.

:func:`m2m_fused_infer` takes the plain version for a tensor on the CPU and
launches the kernel for one on a CUDA device, or raises; it never falls
back. ``m2m_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ...core.activations import leaky_relu
from . import _fused
from ._fused import Affine
from .mmoe_infer import check_block_rows

MAX_EXPERTS = 8    # csrc kMaxExperts
MAX_PRODUCTS = 40  # csrc kMaxSteps: products of a launch, each expert's counted alone


def _check_shapes(t_out, dom_emb, expert_stages, task_stages, scen_stages, vw_stages,
                  vb_stages, tw_stages, tb_stages, v, out_stages, out_head, E):
    """``(B, F, Fd, nE)``; raises on stages that do not chain."""
    if t_out.ndim != 2 or dom_emb.ndim != 2 or dom_emb.shape[0] != t_out.shape[0]:
        raise ValueError(f"t_out [B, F] and dom_emb [B, Fd] expected, got "
                         f"{tuple(t_out.shape)} and {tuple(dom_emb.shape)}")
    B, F = t_out.shape
    Fd = dom_emb.shape[1]
    if not expert_stages:
        raise ValueError("need expert stages")
    nE = expert_stages[0][0].shape[0]
    ends = {"expert": (expert_stages, (nE,), F, E), "task": (task_stages, (), Fd, E),
            "scenario": (scen_stages, (), Fd, E), "vw": (vw_stages, (), E, 4 * E * E),
            "vb": (vb_stages, (), E, 2 * E), "tw": (tw_stages, (), E, E * E),
            "tb": (tb_stages, (), E, E)}
    for what, (stages, lead, width, end) in ends.items():
        if not stages or _fused.check_chain(what, stages, lead, width) != end:
            raise ValueError(f"the {what} stages must run from width {width} to {end}")
    if tuple(v.shape) != (2 * E, 1):
        raise ValueError(f"v must be [{2 * E}, 1], got {tuple(v.shape)}")
    h = _fused.check_chain("output", out_stages, (), E)
    _fused.check_chain("head", [out_head], (), h)
    if out_head[0].shape[-1] != 1:
        raise ValueError("the head must have width 1")
    return B, F, Fd, nE


def m2m_fused_infer_ref(
    t_out: torch.Tensor,               # [B, F] transformer output
    dom_emb: torch.Tensor,             # [B, Fd] scenario feature embedding
    expert_stages: Sequence[Affine],   # stacked (W[nE, in, out], b[nE, out]), leakyrelu
    task_stages: Sequence[Affine],     # leakyrelu, -> [B, E]
    scen_stages: Sequence[Affine],     # leakyrelu, -> [B, E]
    vw_stages: Sequence[Affine],       # leakyrelu, -> [B, 4E²]
    vb_stages: Sequence[Affine],       # leakyrelu, -> [B, 2E]
    tw_stages: Sequence[Affine],       # leakyrelu, -> [B, E²]
    tb_stages: Sequence[Affine],       # leakyrelu, -> [B, E]
    v: torch.Tensor,                   # [2E, 1]
    out_stages: Sequence[Affine],      # relu MLP
    out_head: Affine,                  # (W[h, 1], b[1])
    E: int,
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: the TPU kernel's loops, each
    generated-weight product a sum over its rows in order."""
    _, _, _, nE = _check_shapes(t_out, dom_emb, expert_stages, task_stages, scen_stages,
                                vw_stages, vb_stages, tw_stages, tb_stages, v, out_stages,
                                out_head, E)

    def run(h, stages, act, member=None):
        for w, b in stages:
            h = act(h @ (w if member is None else w[member])
                    + (b if member is None else b[member]))
        return h

    scen = run(dom_emb, scen_stages, leaky_relu)
    task = run(dom_emb, task_stages, leaky_relu)
    experts = [run(t_out, expert_stages, leaky_relu, n) for n in range(nE)]
    vw = run(scen, vw_stages, leaky_relu)   # [B, 4E²], the flat [2E, 2E]
    vb = run(scen, vb_stages, leaky_relu)   # [B, 2E]
    scores = []
    for n in range(nE):
        meta = vb
        for e in range(E):
            meta = meta + experts[n][:, e:e + 1] * vw[:, e * 2 * E:(e + 1) * 2 * E]
        for e in range(E):
            row = e + E
            meta = meta + task[:, e:e + 1] * vw[:, row * 2 * E:(row + 1) * 2 * E]
        scores.append(leaky_relu(meta) @ v)  # [B, 1]
    alpha = torch.softmax(torch.cat(scores, dim=1), dim=1)
    rt = alpha[:, 0:1] * experts[0]
    for n in range(1, nE):
        rt = rt + alpha[:, n:n + 1] * experts[n]
    tw = run(scen, tw_stages, leaky_relu)   # [B, E²]
    h = run(scen, tb_stages, leaky_relu) + rt
    for e in range(E):
        h = h + rt[:, e:e + 1] * tw[:, e * E:(e + 1) * E]
    h = run(leaky_relu(h), out_stages, torch.relu)
    return torch.sigmoid(h @ out_head[0] + out_head[1])[:, 0]


def m2m_fused_infer(
    t_out: torch.Tensor,
    dom_emb: torch.Tensor,
    expert_stages: Sequence[Affine],
    task_stages: Sequence[Affine],
    scen_stages: Sequence[Affine],
    vw_stages: Sequence[Affine],
    vb_stages: Sequence[Affine],
    tw_stages: Sequence[Affine],
    tb_stages: Sequence[Affine],
    v: torch.Tensor,
    out_stages: Sequence[Affine],
    out_head: Affine,
    E: int,
    block_rows: int | None = None,
) -> torch.Tensor:
    """probs[B] = fused M2M eval forward after the transformer.

    ``block_rows``: consecutive rows that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit. A shape whose tile does not fit raises a RuntimeError; it
    never falls back. On the CPU the plain version runs and the value only
    has to keep the tile rule, so that a call that would raise on the card
    for its ``block_rows`` raises there too. The card takes at most
    ``MAX_EXPERTS`` experts and ``MAX_PRODUCTS`` products (each expert's
    stages counted once an expert).
    """
    check_block_rows(block_rows)
    args = (t_out, dom_emb, expert_stages, task_stages, scen_stages, vw_stages, vb_stages,
            tw_stages, tb_stages, v, out_stages, out_head, E)
    if t_out.device.type == "cpu":
        return m2m_fused_infer_ref(*args)
    B, F, Fd, nE = _check_shapes(*args)
    if nE > MAX_EXPERTS:
        raise ValueError(f"m2m_fused_infer takes at most {MAX_EXPERTS} experts, got {nE}")
    groups = [expert_stages, task_stages, scen_stages, vw_stages, vb_stages, tw_stages,
              tb_stages, out_stages, [out_head]]
    products = nE * len(expert_stages) + sum(len(g) for g in groups[1:-1])
    if products > MAX_PRODUCTS:
        raise ValueError(f"m2m_fused_infer takes at most {MAX_PRODUCTS} products, got "
                         f"{products}")
    stages = [s for g in groups for s in g]
    _fused.check_tensors("m2m_fused_infer", t_out, None,
                         [dom_emb, v] + [t for s in stages for t in s])
    out = torch.empty(B, dtype=torch.float32, device=t_out.device)
    if B == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    _fused.launch(
        "m2m_infer", "m2m_fused_infer_f32", (p, p, p, i, i, i, i, i, p, p, p, p, p),
        (t_out.data_ptr(), dom_emb.data_ptr(), out.data_ptr(), B, F, Fd, nE, E,
         _fused.ints([len(g) for g in groups[:-1]]), v.data_ptr(),
         *_fused.stage_args(stages)),
        t_out, block_rows or 0)
    m2m_fused_infer.launches += 1
    return out


m2m_fused_infer.launches = 0
