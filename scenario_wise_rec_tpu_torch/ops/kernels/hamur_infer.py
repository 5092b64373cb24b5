"""Fused HAMUR inference, cut at the adapters' batch-statistics norms: the
CUDA segment kernel ``csrc/hamur_infer.cu`` and its plain PyTorch versions.

HAMUR's eval forward is per row except the adapters' domain norm, which
normalises with the current batch's statistics (masked by ``w``, unbiased
variance), at eval time too. So the stack runs as ``len(adapters) + 1``
segments, one kernel launch each (:func:`hamur_segment`):

- ``first`` (``x = emb [B, F]``): every domain's relu blocks (BatchNorm
  folded), then the adapter ``((h U_down) H_b) V_down`` → sigmoid → up-proj,
  giving the adapter's pre-norm output ``t_pre`` and the blocks' output
  ``h``, both ``[B, D, F_out]``;
- middle (``x = h [B, D, F]``, ``t_pre``): each domain's ``(t_pre - mean) *
  scale + shift + h`` (the previous norm as an affine, and the residual),
  the blocks, the adapter;
- ``final``: the same input and blocks for the row's own domain only, the
  final Linear, the sigmoid: ``probs [B]``.

The hyper-network (``H [B, k, k]``, shared by every adapter) and the norms'
masked statistics, with gamma and beta as ``(mean, scale, shift)``, are
plain PyTorch between the launches, as the JAX package computes them outside
its kernels. The JAX package folds the mean into the shift, ``t * scale +
(beta - mean * scale)``; the port subtracts it first, because where the
batch's variance is near 0 (one real row) ``scale`` reaches ``gamma /
sqrt(eps)`` and the folded form cancels to the rounding of a ~300x larger
product. The activations between segments are ``[B, D, F_out]`` (the TPU
kernel's flat ``[B, D·F_out]`` was a VMEM layout workaround). This replaces
``scenario_wise_rec_tpu/ops/pallas/hamur_infer.py:_segment`` and
``hamur_fused_infer``.

:func:`hamur_segment` takes its plain version (:func:`hamur_segment_ref`)
for tensors on the CPU and launches the kernel for tensors on a CUDA device,
or raises; it never falls back. ``hamur_segment.launches`` counts launches:
HamurLarge makes 3 a batch, HamurSmall 2.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from ..nn import batch_stats
from . import _fused
from ._fused import Affine
from .mmoe_infer import check_block_rows

ADAPTER_KEYS = ("u_down", "v_down", "b_down", "u_up", "v_up", "b_up")
MAX_STAGES = 8  # block stages of a segment the kernel takes (csrc ring::kMaxStages)


def _check_segment(x, stages, hyper, adapter, dn_affine, t_pre, final, domain_id):
    """``(B, F, D, F_out, k, mid)`` of a segment's inputs; raises on what
    does not fit together."""
    first = x.ndim == 2
    if x.ndim not in (2, 3):
        raise ValueError(f"x must be emb [B, F] or h [B, D, F], got {tuple(x.shape)}")
    B, F = x.shape[0], x.shape[-1]
    if not first:
        D = x.shape[1]
    elif stages:
        D = stages[0][0].shape[0]
    elif final is not None:
        D = final[0].shape[0]
    else:
        raise ValueError("a first segment without blocks needs the final stage")
    if first != (t_pre is None) or first != (dn_affine is None):
        raise ValueError("t_pre and dn_affine come with h [B, D, F] and only with it")
    if not first:
        if tuple(t_pre.shape) != tuple(x.shape):
            raise ValueError(f"t_pre {tuple(t_pre.shape)} must match x {tuple(x.shape)}")
        if len(dn_affine) != 3 or any(tuple(a.shape) != (D, F) for a in dn_affine):
            raise ValueError(f"dn_affine must be (mean, scale, shift), each [{D}, {F}]")
    w_out = _fused.check_chain("block", stages, (D,), F)
    if (final is None) == (adapter is None):
        raise ValueError("a segment ends in an adapter or in the final stage, not both")
    if final is not None:
        if domain_id is None:
            raise ValueError("the final segment needs domain_id")
        _fused.check_batch(x.reshape(B, -1), domain_id)
        if _fused.check_chain("final", [final], (D,), w_out) != 1:
            raise ValueError("the final stage must have width 1")
        return B, F, D, w_out, 0, 0
    k = adapter["u_down"].shape[-1]
    mid = adapter["v_down"].shape[-1]
    want = {"u_down": (w_out, k), "v_down": (k, mid), "b_down": (mid,), "u_up": (mid, k),
            "v_up": (k, w_out), "b_up": (w_out,)}
    for key, shape in want.items():
        if tuple(adapter[key].shape) != shape:
            raise ValueError(f"adapter {key} {tuple(adapter[key].shape)} != {shape}")
    if hyper is None or tuple(hyper.shape) != (B, k, k):
        raise ValueError(f"hyper must be [{B}, {k}, {k}]")
    return B, F, D, w_out, k, mid


def hamur_segment_ref(
    x: torch.Tensor,                    # emb [B, F] (first) or h [B, D, F]
    stages: Sequence[Affine],           # each (W[D,in,out], b[D,out]), relu
    hyper: Optional[torch.Tensor] = None,       # [B, k, k], with an adapter
    adapter: Optional[dict] = None,             # u/v/b of the adapter
    dn_affine: Optional[Tuple[torch.Tensor, ...]] = None,  # mean, scale, shift [D, F]
    t_pre: Optional[torch.Tensor] = None,       # [B, D, F], after the first
    final: Optional[Affine] = None,             # (W[D,w,1], b[D,1])
    domain_id: Optional[torch.Tensor] = None,   # [B], with final
):
    """One segment, the plain PyTorch version: a loop over the domains with
    ``@``; ``(t_pre [B, D, F_out], h [B, D, F_out])`` or (final) probs[B]."""
    _, _, D, _, _, _ = _check_segment(x, stages, hyper, adapter, dn_affine, t_pre, final,
                                      domain_id)
    if x.ndim == 2:
        hs = [x] * D
    else:
        mean, scale, shift = dn_affine
        hs = [(t_pre[:, d] - mean[d]) * scale[d] + shift[d] + x[:, d] for d in range(D)]
    for d in range(D):
        for w, b in stages:
            hs[d] = torch.relu(hs[d] @ w[d] + b[d])
    if final is not None:
        did = torch.clamp(domain_id.to(torch.int32).long(), 0, D - 1)
        out = torch.zeros(x.shape[0], dtype=torch.float32, device=x.device)
        for d in range(D):
            y = torch.sigmoid(hs[d] @ final[0][d] + final[1][d])[:, 0]
            out = torch.where(did == d, y, out)
        return out
    a = adapter
    ts = []
    for d in range(D):
        q = torch.einsum("bi,bij->bj", hs[d] @ a["u_down"], hyper)
        t = torch.sigmoid(q @ a["v_down"] + a["b_down"])
        q = torch.einsum("bi,bij->bj", t @ a["u_up"], hyper)
        ts.append(q @ a["v_up"] + a["b_up"])
    return torch.stack(ts, dim=1), torch.stack(hs, dim=1)


def hamur_segment(
    x: torch.Tensor,
    stages: Sequence[Affine],
    hyper: Optional[torch.Tensor] = None,
    adapter: Optional[dict] = None,
    dn_affine: Optional[Tuple[torch.Tensor, ...]] = None,
    t_pre: Optional[torch.Tensor] = None,
    final: Optional[Affine] = None,
    domain_id: Optional[torch.Tensor] = None,
    block_rows: Optional[int] = None,
):
    """One HAMUR segment (the arguments of :func:`hamur_segment_ref`).

    ``block_rows``: rows one block owns on the card, a multiple of 16 up to
    64 whose tiles fit in a block's shared memory beside the smallest rings,
    or None: 32 where a 32-row tile fits, else 16. On the CPU the plain
    version runs and the value only has to keep the tile rule, so that a
    call that would raise on the card raises there too.
    """
    check_block_rows(block_rows)
    if x.device.type == "cpu":
        return hamur_segment_ref(x, stages, hyper, adapter, dn_affine, t_pre, final,
                                 domain_id)
    B, F, D, w_out, k, mid = _check_segment(x, stages, hyper, adapter, dn_affine, t_pre,
                                            final, domain_id)
    if len(stages) > MAX_STAGES:
        raise ValueError(f"hamur_segment takes at most {MAX_STAGES} block stages, "
                         f"got {len(stages)}")
    first = x.ndim == 2
    blocks = list(stages) + ([final] if final is not None else [])
    ad = [] if adapter is None else [adapter[key] for key in ADAPTER_KEYS]
    tensors = [t for s in blocks for t in s] + ad + [
        t for t in (t_pre, hyper, *(dn_affine or ())) if t is not None]
    _fused.check_tensors("hamur_segment", x, domain_id, tensors)
    dev = x.device
    if final is not None:
        out = (torch.empty(B, dtype=torch.float32, device=dev),)
        out_t = out_h = None
        # int64 ids (the trainer's) and int32 ids are read as they are
        did = domain_id if domain_id.dtype in (torch.int32, torch.int64) else \
            domain_id.to(torch.int32)
    else:
        out_t = torch.empty(B, D, w_out, dtype=torch.float32, device=dev)
        out_h = torch.empty_like(out_t)
        out = (out_t, out_h)
        did = None
    if B == 0:
        return out[0] if final is not None else out
    ptr = lambda t: None if t is None else t.data_ptr()
    mean, scale, shift = dn_affine if dn_affine is not None else (None, None, None)
    p, i = ctypes.c_void_p, ctypes.c_int
    _fused.launch(
        "hamur_infer", "hamur_segment_f32",
        (p, p, p, p, p, p, p, p, i, p, p, p, i, i, i, i, i, i, i, i, p, p, p),
        (x.data_ptr(), ptr(t_pre), ptr(mean), ptr(scale), ptr(shift), ptr(hyper),
         _fused.ptrs(ad), ptr(did), int(did is not None and did.dtype == torch.int64),
         ptr(out_t), ptr(out_h), ptr(out[0]) if final is not None else None,
         B, F, D, k, mid, int(first), int(final is not None), len(stages),
         *_fused.stage_args(blocks)),
        x, block_rows or 0)
    hamur_segment.launches += 1
    return out[0] if final is not None else out


hamur_segment.launches = 0


def hamur_hyper(emb: torch.Tensor, hyper_stages: Sequence[Affine], k: int) -> torch.Tensor:
    """The shared hyper-network, BatchNorm folded: ``H [B, k, k]`` (plain
    PyTorch: two products at HAMUR's widths, outside any kernel)."""
    h = emb
    for w, b in hyper_stages:
        h = torch.relu(h @ w + b)
    return h.reshape(-1, k, k)


def adapter_norm_affine(t_pre: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                        eps: float, w: Optional[torch.Tensor]):
    """The adapter norm of ``t_pre [B, D, F]`` as a per-domain affine
    ``(t - mean) * scale + shift``: ``(mean, scale, shift)``, each ``[D,
    F]``, from the batch's mean and unbiased variance over the rows with
    ``w != 0`` and the norm's ``gamma``/``beta`` (``[F]``, shared by the
    domains)."""
    B, D, F = t_pre.shape
    mean, var, n = batch_stats(t_pre.reshape(B, D * F), w)
    var = var * (n / torch.clamp(n - 1.0, min=1.0))
    scale = gamma * torch.rsqrt(var.reshape(D, F) + eps)
    return mean.reshape(D, F), scale, beta.expand(D, F).contiguous()


def _run(segment, emb, domain_id, hyper_stages, k, segments, adapters, final, eps, w,
         **kw):
    if len(segments) != len(adapters) + 1:
        raise ValueError(f"{len(adapters)} adapters need {len(adapters) + 1} segments, "
                         f"got {len(segments)}")
    hyper = hamur_hyper(emb, hyper_stages, k) if adapters else None
    x, t_pre, dn = emb, None, None
    for seg, a in zip(segments, adapters):
        t_pre, x = segment(x, seg, hyper=hyper, adapter=a, dn_affine=dn, t_pre=t_pre, **kw)
        dn = adapter_norm_affine(t_pre, a["gamma"], a["beta"], eps, w)
    return segment(x, segments[-1], dn_affine=dn, t_pre=t_pre, final=final,
                   domain_id=domain_id, **kw)


def hamur_fused_infer(
    emb: torch.Tensor,                    # [B, F]
    domain_id: torch.Tensor,              # [B]
    hyper_stages: Sequence[Affine],       # folded hyper-net affines (relu)
    k: int,
    segments: Sequence[Sequence[Affine]],  # per segment: (W[D,in,out], b[D,out])
    adapters: Sequence[dict],             # u_down v_down b_down u_up v_up b_up gamma beta
    final: Affine,                        # (W[D,w,1], b[D,1])
    eps: float = 1e-5,
    w: Optional[torch.Tensor] = None,     # [B] 0/1 padding mask for the norms
    block_rows: Optional[int] = None,
) -> torch.Tensor:
    """probs[B]: HAMUR's eval forward after the embedding, one
    :func:`hamur_segment` launch per segment, the hyper-network and the
    adapter norms' statistics in PyTorch between them."""
    return _run(hamur_segment, emb, domain_id, hyper_stages, k, segments, adapters, final,
                eps, w, block_rows=block_rows)


def hamur_fused_infer_ref(emb, domain_id, hyper_stages, k, segments, adapters, final,
                          eps: float = 1e-5, w=None) -> torch.Tensor:
    """probs[B], the plain version of :func:`hamur_fused_infer` on any
    device: every segment by :func:`hamur_segment_ref`."""
    return _run(hamur_segment_ref, emb, domain_id, hyper_stages, k, segments, adapters,
                final, eps, w)
