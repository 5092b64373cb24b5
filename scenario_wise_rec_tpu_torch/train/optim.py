"""Optimizers matching the reference's torch defaults (the JAX package's
``train/optim.py``).

The reference uses ``torch.optim.Adam(lr=1e-3, weight_decay=1e-5)``
(ctr_trainer.py:50-52): weight decay is added to the *gradient* before the
moment updates (Adam, not AdamW). The JAX package writes that as an optax
chain; here it is ``torch.optim.Adam`` itself.

The sorted embedding update keeps the packed table out of that optimizer
and updates it with :func:`sorted_dense_adam_update`: exact dense Adam on
every row, from the per-occurrence gradient rows, through the kernel of
``ops/kernels/sorted_adam.py``. Its authority is the model's own
``embedding.packed`` parameter, a plain ``[V, D]`` tensor updated in place;
``mu`` and ``nu`` are ``[V, D]`` tensors in the optimizer state. (The TPU
kept a padded, packed ``[V2/r, 128]`` copy; that layout is not carried over,
so eval reads the live table directly.)

The reference passes StepLR ``scheduler_params`` but never a
``scheduler_fn``, so its lr is constant; :func:`step_lr` is provided for
capability parity.
"""

from __future__ import annotations

import functools
from typing import Dict

import torch

from ..ops.kernels.sorted_adam import (DEFAULT_BLOCK_ROWS, adam_hparams,
                                       owner_sorted_grads,
                                       sorted_dense_adam_apply)


def adam(lr: float = 1e-3, weight_decay: float = 1e-5, b1: float = 0.9,
         b2: float = 0.999, eps: float = 1e-8):
    """A ``params -> torch.optim.Adam`` factory: torch-Adam with weight decay
    folded into the gradient, the math of the JAX package's
    ``add_decayed_weights`` + ``scale_by_adam`` chain."""
    return functools.partial(torch.optim.Adam, lr=lr, betas=(b1, b2), eps=eps,
                             weight_decay=weight_decay)


def step_lr(step_size: int, gamma: float):
    """StepLR multiplier ``gamma ** (epoch // step_size)`` of the *epoch*
    index (the reference steps its scheduler once per epoch,
    ctr_trainer.py:83-86)."""

    def schedule(epoch):
        return gamma ** (epoch // step_size)

    return schedule


def sorted_dense_adam_init(table: torch.Tensor) -> Dict:
    """Optimizer state for :func:`sorted_dense_adam_update`: zero ``[V, D]``
    moments beside the table and a host step count."""
    return {"mu": torch.zeros_like(table, memory_format=torch.contiguous_format),
            "nu": torch.zeros_like(table, memory_format=torch.contiguous_format),
            "step": 0}


def sorted_dense_adam_update(table: torch.Tensor, opt_state: Dict,
                             g_rows: torch.Tensor, ids: torch.Tensor, *,
                             lr: float = 1e-3, weight_decay: float = 1e-5,
                             b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                             block_rows: int = DEFAULT_BLOCK_ROWS) -> Dict:
    """One exact dense torch-Adam step of ``table`` (in place) from the
    per-occurrence gradient rows ``g_rows [K, D]`` of the packed rows
    ``ids [K]`` (``EmbeddingCollection.touched_ids``, duplicates allowed).

    Identical semantics to the reference's ``torch.optim.Adam`` over
    ``nn.Embedding.weight``: every row receives weight decay and moment
    decay every step. ``hp`` is computed on the host from the integer step
    count, so the step costs no device sync. Updates ``opt_state`` in place
    and returns it. (The JAX function also takes the owner segments and
    offsets, which its per-owner sorts need; one global sort here does
    not.)
    """
    step = int(opt_state["step"]) + 1
    hp = adam_hparams(step, lr, weight_decay, b1, b2, eps)
    sorted_ids, g_sorted = owner_sorted_grads(ids, g_rows)
    sorted_dense_adam_apply(table.detach(), opt_state["mu"], opt_state["nu"],
                            sorted_ids, g_sorted.contiguous(), hp,
                            block_rows=block_rows)
    opt_state["step"] = step
    return opt_state
