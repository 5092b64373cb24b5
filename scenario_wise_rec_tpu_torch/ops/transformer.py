"""torch-parity Transformer (post-norm encoder/decoder), the JAX package's
``ops/transformer.py``.

It exists for M2M, which feeds its flat ``[B, D]`` embedding to
``nn.Transformer(d_model=input_dim, nhead=4, 2 enc / 2 dec, ff=16)`` as an
*unbatched sequence of length B*: attention mixes information **across the
examples of a batch**. The quirk is the reference's and is kept: this
module works on one ``[L, E]`` sequence.

Semantics: post-norm layers, ReLU feed-forward, dropout (0.1 by default) on
the attention weights, both residual branches and the feed-forward hidden,
a final LayerNorm on both stacks, xavier-uniform matrices, zero attention
biases. The parameters keep the JAX tree's names and layouts, so that
``interop`` copies them by path: ``enc[i]/{attn, ff/{l1,l2}, norm1, norm2}``,
``dec[i]/{self_attn, cross_attn, ff, norm1, norm2, norm3}``, ``enc_norm``,
``dec_norm``; an attention's ``in_w [3d, d]`` and ``out_w [d, d]`` are stored
(out, in) and used transposed, ``ff``'s ``w`` (in, out).

Inside a mesh step or eval batch (``parallel.mesh_step``) the sequence is
the global batch while each rank holds its rows: every self- and
cross-attention takes its keys, values and key mask over the ``data`` group
(``parallel.mesh.all_gather_rows_autograd``, whose backward sums the keys'
and values' gradients over the group), and the queries stay this rank's
rows, so a rank's scores are ``[nh, L_local, L_global]`` and its outputs
are one process's rows. The attention dropout then draws the global
``[nh, L_global, L_global]`` mask and keeps its own query rows
(``ops/nn.py:dropout``).

Every product is a plain f32 ``@``, in the bf16 compute mode too, as in the
JAX package. The scores are plain products, a mask fill with
``finfo(float32).min`` and a softmax, so that dropout can draw from the
caller's ``torch.Generator`` (``scaled_dot_product_attention`` takes none).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..core import init as initializers
from ..parallel.mesh import all_gather_rows, all_gather_rows_autograd, current_step
from .nn import LayerNorm
from .nn import dropout as dropout_fn


class MultiheadAttention(nn.Module):
    """``in_w [3d, d]`` (q, k, v stacked), ``in_b``, ``out_w [d, d]``,
    ``out_b``; xavier matrices and zero biases."""

    def __init__(self, d_model: int, generator: torch.Generator):
        super().__init__()
        xavier = initializers.xavier_uniform()
        dev = generator.device
        self.in_w = nn.Parameter(xavier(generator, (3 * d_model, d_model)))
        self.in_b = nn.Parameter(torch.zeros(3 * d_model, device=dev))
        self.out_w = nn.Parameter(xavier(generator, (d_model, d_model)))
        self.out_b = nn.Parameter(torch.zeros(d_model, device=dev))
        self._scales = {}

    def _scale(self, hd: int, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """``sqrt(hd)`` as a 0-dim tensor on ``device``, made once: a copy
        from host memory per forward would refuse a CUDA graph capture. Made
        outside inference mode, so that a train step may save it for
        backward after an eval pass made it."""
        key = (hd, dtype, device)
        if key not in self._scales:
            with torch.inference_mode(False):
                self._scales[key] = torch.tensor(math.sqrt(hd), dtype=dtype, device=device)
        return self._scales[key]

    def forward(self, q_in, kv_in, nhead: int, p_drop: float, train: bool,
                generator: Optional[torch.Generator], key_mask=None):
        """Attention of the ``[L, E]`` queries over the ``[S, E]`` keys and
        values. ``key_mask``: optional ``[S]`` 0/1 mask; keys at 0 (a
        batch's padding rows) take no part, as if the row did not exist."""
        L, E = q_in.shape
        S = kv_in.shape[0]
        hd = E // nhead
        w_q, w_k, w_v = torch.split(self.in_w, E, dim=0)
        b_q, b_k, b_v = torch.split(self.in_b, E, dim=0)
        q = (q_in @ w_q.T + b_q).reshape(L, nhead, hd).transpose(0, 1)
        k = (kv_in @ w_k.T + b_k).reshape(S, nhead, hd).transpose(0, 1)
        v = (kv_in @ w_v.T + b_v).reshape(S, nhead, hd).transpose(0, 1)
        scale = self._scale(hd, q.dtype, q.device)
        attn = torch.einsum("hld,hsd->hls", q, k) / scale
        if key_mask is not None:
            attn = torch.where(key_mask[None, None, :] > 0, attn,
                               torch.finfo(attn.dtype).min)
        attn = torch.softmax(attn, dim=-1)
        attn = dropout_fn(attn, p_drop, train, generator)
        out = torch.einsum("hls,hsd->hld", attn, v).transpose(0, 1).reshape(L, E)
        return out @ self.out_w.T + self.out_b


class FeedForward(nn.Module):
    """``l1 [d, ff]`` and ``l2 [ff, d]``, each ``{w, b}``: xavier matrices,
    torch Linear biases."""

    def __init__(self, d_model: int, d_ff: int, generator: torch.Generator):
        super().__init__()
        xavier = initializers.xavier_uniform()
        for name, (i, o) in (("l1", (d_model, d_ff)), ("l2", (d_ff, d_model))):
            p = initializers.linear_params(generator, i, o)
            lin = nn.Module()
            lin.w = nn.Parameter(xavier(generator, (i, o)))
            lin.b = nn.Parameter(p["b"])
            setattr(self, name, lin)

    def forward(self, x, p_drop: float, train: bool, generator):
        h = torch.relu(x @ self.l1.w + self.l1.b)
        h = dropout_fn(h, p_drop, train, generator)
        return h @ self.l2.w + self.l2.b


class _EncoderLayer(nn.Module):
    def __init__(self, d_model, d_ff, generator):
        super().__init__()
        dev = generator.device
        self.attn = MultiheadAttention(d_model, generator)
        self.ff = FeedForward(d_model, d_ff, generator)
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)


class _DecoderLayer(nn.Module):
    def __init__(self, d_model, d_ff, generator):
        super().__init__()
        dev = generator.device
        self.self_attn = MultiheadAttention(d_model, generator)
        self.cross_attn = MultiheadAttention(d_model, generator)
        self.ff = FeedForward(d_model, d_ff, generator)
        self.norm1 = LayerNorm(d_model, device=dev)
        self.norm2 = LayerNorm(d_model, device=dev)
        self.norm3 = LayerNorm(d_model, device=dev)


class Transformer(nn.Module):
    """The full encoder-decoder stack; ``forward(src[L, E], tgt[L, E])``
    returns the decoded ``[L, E]``."""

    def __init__(self, d_model: int, nhead: int = 4, num_encoder_layers: int = 2,
                 num_decoder_layers: int = 2, dim_feedforward: int = 16,
                 dropout: float = 0.1, *, generator: torch.Generator):
        super().__init__()
        if d_model % nhead:
            raise ValueError(f"d_model {d_model} is not a multiple of nhead {nhead}")
        self.d_model, self.nhead = d_model, nhead
        self.d_ff, self.p = dim_feedforward, float(dropout)
        dev = generator.device
        self.enc = nn.ModuleList([_EncoderLayer(d_model, dim_feedforward, generator)
                                  for _ in range(num_encoder_layers)])
        self.dec = nn.ModuleList([_DecoderLayer(d_model, dim_feedforward, generator)
                                  for _ in range(num_decoder_layers)])
        self.enc_norm = LayerNorm(d_model, device=dev)
        self.dec_norm = LayerNorm(d_model, device=dev)

    def _res(self, x, sub, train, generator):
        return x + dropout_fn(sub, self.p, train, generator)

    @staticmethod
    def _global(t):
        """The global batch's rows of ``t`` inside a mesh step (gathered
        over ``data``, differentiable), else ``t``."""
        step = current_step()
        return t if step is None else all_gather_rows_autograd(t, step.group)

    def forward(self, src, tgt, train: bool = False,
                generator: Optional[torch.Generator] = None, w=None):
        """``w``: optional ``[L]`` 0/1 padding mask over the positions (the
        batch's rows): padded rows are masked out as attention keys in every
        self- and cross-attention, as in the reference, where they do not
        exist. Their own outputs are garbage and must be discarded. Dropout
        (train mode, ``p > 0``) draws from ``generator``. Inside a mesh step
        ``src``, ``tgt`` and ``w`` are this rank's rows (module docstring)."""
        p, nh = self.p, self.nhead
        step = current_step()
        if step is not None and w is not None:
            w = all_gather_rows(w, step.group)  # the global batch's key mask
        kv = self._global
        h = src
        for layer in self.enc:
            a = layer.attn(h, kv(h), nh, p, train, generator, key_mask=w)
            h = layer.norm1(self._res(h, a, train, generator))
            f = layer.ff(h, p, train, generator)
            h = layer.norm2(self._res(h, f, train, generator))
        memory = kv(self.enc_norm(h))
        t = tgt
        for layer in self.dec:
            a = layer.self_attn(t, kv(t), nh, p, train, generator, key_mask=w)
            t = layer.norm1(self._res(t, a, train, generator))
            c = layer.cross_attn(t, memory, nh, p, train, generator, key_mask=w)
            t = layer.norm2(self._res(t, c, train, generator))
            f = layer.ff(t, p, train, generator)
            t = layer.norm3(self._res(t, f, train, generator))
        return self.dec_norm(t)
