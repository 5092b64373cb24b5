"""Eval-time constant folding: Linear→BatchNorm chains become one affine.

Plain PyTorch, not a kernel (the JAX package's ``ops/pallas/folding.py`` is
XLA code too). At eval, BatchNorm1d normalizes with *running* statistics,
per-feature constants, so ``BN(xW + b)`` folds into ``x W' + b'`` with

    scale = gamma / sqrt(running_var + eps)
    W'    = W * scale
    b'    = (b - running_mean) * scale + beta

in that operation order, so the folded weights match the JAX package's to
the ulp. This is the precondition of the fused inference kernels: an eval
MLP collapses to a chain of affine+activation stages.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from ..nn import BN_EPS, MLP

Affine = Tuple[torch.Tensor, torch.Tensor]  # (W, b), possibly stacked [N, in, out]


@torch.no_grad()
def fold_layers_eval(layers) -> List[Affine]:
    """Fold Linear -> BatchNorm layers (each with ``lin`` and ``bn``, as an
    ``MLP``'s) into affine stages ``(W, b)``."""
    stages: List[Affine] = []
    for layer in layers:
        bn, lin = layer.bn, layer.lin
        scale = bn.gamma / torch.sqrt(bn.var + BN_EPS)
        w = lin.w * scale[..., None, :]
        b = (lin.b - bn.mean) * scale + bn.beta
        stages.append((w, b))
    return stages


@torch.no_grad()
def fold_stacked_mlp_eval(mlp: MLP) -> Tuple[List[Affine], Optional[Affine]]:
    """Fold a (stacked) ``MLP``'s eval forward into affine stages.

    Returns ``(hidden_stages, out_stage)``; each stage is ``(W, b)``, and
    ``out_stage`` is ``None`` when the MLP has no output head.
    """
    stages = fold_layers_eval(mlp.layers)
    out_stage = (mlp.out.w.detach(), mlp.out.b.detach()) if mlp.out is not None \
        else None
    return stages, out_stage


@torch.no_grad()
def fold_bn_linear_eval(bn, lin) -> Affine:
    """Fold the *reversed* order ``Linear(BN(x))`` into one affine.

    ``(x - m)·s·W + b`` with ``s = gamma/sqrt(var+eps)`` becomes
    ``x W' + b'`` where ``W' = diag(s)·W`` (scale the *rows* of W) and
    ``b' = b + (beta - m·s) @ W``. ``bn`` carries ``gamma, beta, mean,
    var`` and ``lin`` carries ``w, b``; leading member axes broadcast.
    """
    scale = bn.gamma / torch.sqrt(bn.var + BN_EPS)
    shift = bn.beta - bn.mean * scale
    w = lin.w * scale[..., :, None]
    b = lin.b + torch.einsum("...i,...io->...o", shift, lin.w)
    return w, b
