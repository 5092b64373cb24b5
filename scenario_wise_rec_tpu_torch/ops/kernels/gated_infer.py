"""Fused inference of the gated-personalization family: EPNet, PPNet and
AdaSparse, the CUDA kernels of ``csrc/ppnet_infer.cu`` (PPNet) and
``csrc/adasparse_infer.cu`` (AdaSparse and EPNet) and their plain PyTorch
versions.

- :func:`epnet_fused_infer`: ``gate = gemma·sigmoid(relu([sce ‖ agn] W1 +
  b1) W2 + b2)``, then ``sigmoid((agn · gate) Wo + bo)``. The kernel is
  AdaSparse's, run on a list of two steps: gate l1 reads ``[sce ‖ agn]`` as
  one operand, gate l2's epilogue multiplies the gate into ``agn`` in
  place, and the head reads the gated ``agn``; every product on the tensor
  cores in 3xTF32 (about f32's accuracy).
- :func:`ppnet_fused_infer`: per domain, from the gate input ``g``, each
  layer ``relu(h W_i + b_i) · GateNU_i(g)`` (BatchNorm folded), then
  ``sigmoid(h Wf + bf)``, each row's own domain selected. The kernel runs
  only the row's own domain's tower: each block takes rows of one domain,
  partitioned inside the launch, and runs the products on the tensor cores
  in 3xTF32 (about f32's accuracy; the design note is at the top of the
  source).
- :func:`adasparse_fused_infer`: the agnostic embedding and every hidden
  activation multiplied by its pruner's weights, then ``sigmoid(h Wf +
  bf)``; ``alpha`` comes folded into the pruner weights (Binarization,
  Fusion) and ``form`` picks the threshold's form. The kernel gives each
  block a tile of consecutive rows and runs every pruner and layer on the
  tensor cores in 3xTF32 (about f32's accuracy; the design note is at the
  top of the source).

They replace the TPU kernels of ``scenario_wise_rec_tpu/ops/pallas/
gated_infer.py``. The plain versions split a product with a
concatenation, ``[s ‖ a] W = s W[:S] + a W[S:]``; the kernels keep ``s`` in
the first columns of the activation tile and read ``[s ‖ a]`` as one
operand.

Each wrapper takes the plain version for a tensor on the CPU and launches
its kernel for one on a CUDA device, or raises; it never falls back. Each
counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from . import _fused
from ._fused import Affine
from .mmoe_infer import ROW_TILE, check_block_rows

FORMS = ("Binarization", "Scaling", "Fusion")  # the kernel's form flag is the index
MAX_LAYERS = 30  # csrc kMaxLayers (ppnet_infer.cu, adasparse_infer.cu)
MAX_DOMAINS = 256  # ppnet_infer.cu kMaxDomains


def _check_pair(sce, agn):
    if sce.ndim != 2 or agn.ndim != 2 or sce.shape[0] != agn.shape[0]:
        raise ValueError(f"sce [B, S] and agn [B, A] must share B, got {tuple(sce.shape)} "
                         f"and {tuple(agn.shape)}")
    return sce.shape[0], sce.shape[1], agn.shape[1]


# -- EPNet --------------------------------------------------------------------------


def _epnet_shapes(sce, agn, gate_l1, gate_l2, head):
    B, S, A = _check_pair(sce, agn)
    h = _fused.check_chain("gate l1", [gate_l1], (), S + A)
    if _fused.check_chain("gate l2", [gate_l2], (), h) != A:
        raise ValueError(f"the gate must end at the agnostic width {A}")
    if _fused.check_chain("head", [head], (), A) != 1:
        raise ValueError("the head must have width 1")
    return B, S, A


def epnet_fused_infer_ref(
    sce: torch.Tensor,     # [B, S]
    agn: torch.Tensor,     # [B, A]
    gate_l1: Affine,       # (W[S+A, H], b[H])
    gate_l2: Affine,       # (W[H, A], b[A])
    head: Affine,          # (W[A, 1], b[1])
    gemma: float = 2.0,
) -> torch.Tensor:
    """probs[B], the plain PyTorch version (the TPU kernel's expressions)."""
    _, S, _ = _epnet_shapes(sce, agn, gate_l1, gate_l2, head)
    w1, b1 = gate_l1
    h = torch.relu(sce @ w1[:S] + agn @ w1[S:] + b1)
    gate = gemma * torch.sigmoid(h @ gate_l2[0] + gate_l2[1])
    return torch.sigmoid((agn * gate) @ head[0] + head[1])[:, 0]


def epnet_fused_infer(sce, agn, gate_l1: Affine, gate_l2: Affine, head: Affine,
                      gemma: float = 2.0, block_rows: int | None = None) -> torch.Tensor:
    """probs[B] = fused EPNet eval forward on the embedded ``sce``, ``agn``.

    ``block_rows``: consecutive rows that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit. A shape whose tile does not fit raises a RuntimeError; it
    never falls back. On the CPU the plain version runs and the value only
    has to keep the tile rule, so that a call that would raise on the card
    for its ``block_rows`` raises there too.
    """
    check_block_rows(block_rows)
    if sce.device.type == "cpu":
        return epnet_fused_infer_ref(sce, agn, gate_l1, gate_l2, head, gemma)
    B, S, A = _epnet_shapes(sce, agn, gate_l1, gate_l2, head)
    stages = [gate_l1, gate_l2, head]
    _fused.check_tensors("epnet_fused_infer", sce, None, [agn] + [t for s in stages for t in s])
    out = torch.empty(B, dtype=torch.float32, device=sce.device)
    if B == 0:
        return out
    p, i = ctypes.c_void_p, ctypes.c_int
    _fused.launch("adasparse_infer", "epnet_fused_infer_f32",
                  (p, p, p, i, i, i, ctypes.c_float, p, p, p),
                  (sce.data_ptr(), agn.data_ptr(), out.data_ptr(), B, S, A, gemma,
                   *_fused.stage_args(stages)), sce, block_rows or 0)
    epnet_fused_infer.launches += 1
    return out


epnet_fused_infer.launches = 0


# -- PPNet --------------------------------------------------------------------------


def _ppnet_shapes(gate_in, domain_id, layer_stages, gate_l1s, gate_l2s, final):
    B, G = _fused.check_batch(gate_in, domain_id)
    D = final[0].shape[0]
    if not len(layer_stages) == len(gate_l1s) == len(gate_l2s):
        raise ValueError("each layer needs one gate l1 and one gate l2 stage")
    width = G
    for i, (lay, g1, g2) in enumerate(zip(layer_stages, gate_l1s, gate_l2s)):
        width = _fused.check_chain(f"layer {i}", [lay], (D,), width)
        h = _fused.check_chain(f"gate {i} l1", [g1], (D,), G)
        if _fused.check_chain(f"gate {i} l2", [g2], (D,), h) != width:
            raise ValueError(f"gate {i} must end at its layer's width {width}")
    if _fused.check_chain("final", [final], (D,), width) != 1:
        raise ValueError("the final stage must have width 1")
    return B, G, D


def ppnet_fused_infer_ref(
    gate_in: torch.Tensor,             # [B, G] = id_emb ‖ agn_emb
    domain_id: torch.Tensor,           # [B]
    layer_stages: Sequence[Affine],    # each (W[D, in, out], b[D, out]) folded
    gate_l1s: Sequence[Affine],        # each (W[D, G, H_i], b[D, H_i])
    gate_l2s: Sequence[Affine],        # each (W[D, H_i, out_i], b[D, out_i])
    final: Affine,                     # (W[D, h, 1], b[D, 1])
    gemma: float = 2.0,
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: every domain's tower with ``@``
    and a select of each row's domain (the TPU kernel's loops)."""
    _, _, D = _ppnet_shapes(gate_in, domain_id, layer_stages, gate_l1s, gate_l2s, final)
    did = torch.clamp(domain_id.to(torch.int32).long(), 0, D - 1)
    out = torch.zeros(gate_in.shape[0], dtype=torch.float32, device=gate_in.device)
    for d in range(D):
        h = gate_in
        for (w, b), (w1, b1), (w2, b2) in zip(layer_stages, gate_l1s, gate_l2s):
            m = torch.relu(h @ w[d] + b[d])
            gh = torch.relu(gate_in @ w1[d] + b1[d])
            h = m * (gemma * torch.sigmoid(gh @ w2[d] + b2[d]))
        y = torch.sigmoid(h @ final[0][d] + final[1][d])[:, 0]
        out = torch.where(did == d, y, out)
    return out


def ppnet_fused_infer(gate_in, domain_id, layer_stages: Sequence[Affine],
                      gate_l1s: Sequence[Affine], gate_l2s: Sequence[Affine], final: Affine,
                      gemma: float = 2.0, block_rows: int | None = None) -> torch.Tensor:
    """probs[B] = fused PPNet eval forward on the gate input ``gate_in``.

    ``block_rows``: rows of one domain that one block owns on the card, a
    multiple of 16 up to 64 whose tile fits in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit. A shape whose tile does not fit raises a RuntimeError; it
    never falls back. On the CPU the plain version runs and the value only
    has to keep the tile rule, so that a call that would raise on the card
    for its ``block_rows`` raises there too. The card takes at most
    ``MAX_LAYERS`` layers and ``MAX_DOMAINS`` domains; int32 and int64
    domain ids are read as they are.
    """
    check_block_rows(block_rows)
    if gate_in.device.type == "cpu":
        return ppnet_fused_infer_ref(gate_in, domain_id, layer_stages, gate_l1s, gate_l2s,
                                     final, gemma)
    B, G, D = _ppnet_shapes(gate_in, domain_id, layer_stages, gate_l1s, gate_l2s, final)
    n = len(layer_stages)
    if n > MAX_LAYERS:
        raise ValueError(f"ppnet_fused_infer takes at most {MAX_LAYERS} layers, got {n}")
    if D > MAX_DOMAINS:
        raise ValueError(f"ppnet_fused_infer takes at most {MAX_DOMAINS} domains, got {D}")
    stages = list(layer_stages) + list(gate_l1s) + list(gate_l2s) + [final]
    _fused.check_tensors("ppnet_fused_infer", gate_in, domain_id,
                         [t for s in stages for t in s])
    out = torch.empty(B, dtype=torch.float32, device=gate_in.device)
    if B == 0:
        return out
    did = domain_id if domain_id.dtype in (torch.int32, torch.int64) else \
        domain_id.to(torch.int32)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _fused.function("ppnet_infer", "ppnet_fused_infer_f32",
                         (p, p, i, p, i, i, i, i, ctypes.c_float, p, p, p))
    smem = ctypes.c_size_t(0)
    stream = torch.cuda.current_stream(gate_in.device).cuda_stream
    with torch.cuda.device(gate_in.device):
        err = fn(gate_in.data_ptr(), did.data_ptr(), did.dtype == torch.int64, out.data_ptr(),
                 B, G, D, n, gemma, *_fused.stage_args(stages), block_rows or 0, stream,
                 ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(
            f"ppnet_fused_infer launch failed with cudaError {err} ({smem.value} bytes of "
            f"shared memory per block, block_rows={block_rows or ROW_TILE})")
    ppnet_fused_infer.launches += 1
    return out


ppnet_fused_infer.launches = 0


# -- AdaSparse ----------------------------------------------------------------------


def _adasparse_shapes(sce, agn, pruner_ws, layer_stages, final, form):
    B, S, A = _check_pair(sce, agn)
    if form not in FORMS:
        raise ValueError(f"form must be one of {list(FORMS)}, got {form!r}")
    if len(pruner_ws) != len(layer_stages) + 1:
        raise ValueError("one pruner before the layers and one after each")
    widths = [A]
    width = _fused.check_chain("layers", layer_stages, (), S + A)
    widths += [w.shape[-1] for w, _ in layer_stages]
    for i, (p, h) in enumerate(zip(pruner_ws, widths)):
        if tuple(p.shape) != (S + h, h):
            raise ValueError(f"pruner {i} must be [{S + h}, {h}], got {tuple(p.shape)}")
    if _fused.check_chain("final", [final], (), width) != 1:
        raise ValueError("the final stage must have width 1")
    return B, S, A


def _thresholded(v, form, beta):
    """What a pruner compares with epsilon: ``sigmoid(v)`` for Binarization,
    ``beta·sigmoid(v)`` otherwise (alpha already folded into ``v``)."""
    return torch.sigmoid(v) if form == "Binarization" else beta * torch.sigmoid(v)


def _adasparse_plain(sce, agn, pruner_ws, layer_stages, final, form, epsilon, beta):
    """``(probs [B], margin [B])``: the margin is each row's least
    ``|thresholded - epsilon|`` over every pruner element."""
    _, S, _ = _adasparse_shapes(sce, agn, pruner_ws, layer_stages, final, form)
    margin = torch.full((sce.shape[0],), float("inf"), device=sce.device)

    def pruned(p, x):
        nonlocal margin
        t = _thresholded(sce @ p[:S] + x @ p[S:], form, beta)
        margin = torch.minimum(margin, (t - epsilon).abs().amin(dim=1))
        w = torch.sign(t - epsilon) if form == "Binarization" else t * torch.sign(t - epsilon)
        return w * x

    a = pruned(pruner_ws[0], agn)
    if not layer_stages:  # the head acts on [sce ‖ pruned agn]
        logit = sce @ final[0][:S] + a @ final[0][S:] + final[1]
        return torch.sigmoid(logit)[:, 0], margin
    w, b = layer_stages[0]
    h = pruned(pruner_ws[1], torch.relu(sce @ w[:S] + a @ w[S:] + b))
    for i, (w, b) in enumerate(layer_stages[1:], 2):
        h = pruned(pruner_ws[i], torch.relu(h @ w + b))
    return torch.sigmoid(h @ final[0] + final[1])[:, 0], margin


def adasparse_threshold_margin(sce, agn, pruner_ws, layer_stages, final, form="Fusion",
                               epsilon=1e-2, beta=2.0) -> torch.Tensor:
    """``[B]``: how near each row's pruners lie to their hard threshold, the
    least ``|thresholded - epsilon|`` over every pruner element, from the
    plain version. A kernel and the plain version that differ in the last
    ulp can flip a factor only in a row whose margin is within rounding of
    0: a comparison of the two excludes the rows below a stated margin."""
    return _adasparse_plain(sce, agn, pruner_ws, layer_stages, final, form, epsilon,
                            beta)[1]


def adasparse_fused_infer_ref(
    sce: torch.Tensor,                  # [B, S]
    agn: torch.Tensor,                  # [B, A]
    pruner_ws: Sequence[torch.Tensor],  # [S+A, A], then [S+h_i, h_i] (alpha folded)
    layer_stages: Sequence[Affine],     # each (W[in, out], b[out]) folded
    final: Affine,                      # (W[h, 1], b[1])
    form: str = "Fusion",
    epsilon: float = 1e-2,
    beta: float = 2.0,
) -> torch.Tensor:
    """probs[B], the plain PyTorch version (the TPU kernel's expressions)."""
    return _adasparse_plain(sce, agn, pruner_ws, layer_stages, final, form, epsilon, beta)[0]


def adasparse_fused_infer(sce, agn, pruner_ws: Sequence[torch.Tensor],
                          layer_stages: Sequence[Affine], final: Affine,
                          form: str = "Fusion", epsilon: float = 1e-2, beta: float = 2.0,
                          block_rows: int | None = None) -> torch.Tensor:
    """probs[B] = fused AdaSparse eval forward on the embedded ``sce``, ``agn``.

    ``block_rows``: consecutive rows that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit. A shape whose tile does not fit raises a RuntimeError; it
    never falls back. On the CPU the plain version runs and the value only
    has to keep the tile rule, so that a call that would raise on the card
    for its ``block_rows`` raises there too. The card takes at most
    ``MAX_LAYERS`` layers.
    """
    check_block_rows(block_rows)
    if sce.device.type == "cpu":
        return adasparse_fused_infer_ref(sce, agn, pruner_ws, layer_stages, final, form,
                                         epsilon, beta)
    B, S, A = _adasparse_shapes(sce, agn, pruner_ws, layer_stages, final, form)
    n = len(layer_stages)
    if n > MAX_LAYERS:
        raise ValueError(f"adasparse_fused_infer takes at most {MAX_LAYERS} layers, got {n}")
    stages = [(p, None) for p in pruner_ws] + list(layer_stages) + [final]
    _fused.check_tensors("adasparse_fused_infer", sce, None,
                         [agn] + [t for s in stages for t in s if t is not None])
    out = torch.empty(B, dtype=torch.float32, device=sce.device)
    if B == 0:
        return out
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = _fused.function("adasparse_infer", "adasparse_fused_infer_f32",
                         (p, p, p, i, i, i, i, i, f, f, p, p, p))
    smem = ctypes.c_size_t(0)
    stream = torch.cuda.current_stream(sce.device).cuda_stream
    with torch.cuda.device(sce.device):
        err = fn(sce.data_ptr(), agn.data_ptr(), out.data_ptr(), B, S, A, n,
                 FORMS.index(form), epsilon, beta, *_fused.stage_args(stages),
                 block_rows or 0, stream, ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(
            f"adasparse_fused_infer launch failed with cudaError {err} ({smem.value} bytes of "
            f"shared memory per block, block_rows={block_rows or ROW_TILE})")
    adasparse_fused_infer.launches += 1
    return out


adasparse_fused_infer.launches = 0
