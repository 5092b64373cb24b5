"""Model protocol + template.

Every model is an ``nn.Module`` built on an explicit device from an explicit
``torch.Generator`` and exposing

- ``apply(x, train=False, w=None, generator=None, rows=None) -> probs[B]``
  (``w`` = optional [B] 0/1 padding mask: static-shape batches pad ragged
  tails with weight-0 rows, and every batch-statistics op excludes them;
  padded rows' outputs are discarded host-side; ``rows`` = optional
  pre-gathered packed embedding rows, see ``EmbeddingCollection.forward``).
  A train-mode call updates the BatchNorm running stats in place.

``x`` is a dict of per-column tensors; ``probs`` are post-sigmoid click
probabilities. The multi-scenario contract: read ``x["domain_indicator"]``,
compute every domain branch on the full batch, and select per row.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..core.config import make_generator, resolve_device
from ..core.features import sum_embed_dims
from ..ops.embedding import EmbeddingCollection
from ..ops.select import domain_select


def domain_ids(x) -> torch.Tensor:
    return x["domain_indicator"].to(torch.int32)


def model_generator(device, generator: Optional[torch.Generator]) -> torch.Generator:
    """The generator a model draws its initial weights from: the caller's,
    or one seeded with 0 on ``device`` (``None`` means the card). The model
    lives on the generator's device, which must be ``device``."""
    dev = resolve_device(device)
    if generator is None:
        return make_generator(dev, 0)
    if generator.device.type != dev.type:
        raise ValueError(f"generator on {generator.device}, model on {dev}")
    return generator


class Model(nn.Module):
    """Base class (also the user template)."""

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        raise NotImplementedError

    def forward(self, x, train: bool = False, w=None, generator=None, rows=None):
        return self.apply(x, train=train, w=w, generator=generator, rows=rows)


class Base(Model):
    """Documented skeleton for user models: embed -> (user-defined
    per-domain computation) -> per-row select. As shipped, the reference
    template's forward is an identity over the flattened embedding selected
    per domain; reproduced for parity."""

    def __init__(self, features, num_domains: int, device="cuda",
                 generator: Optional[torch.Generator] = None, **kwargs):
        super().__init__()
        gen = model_generator(device, generator)
        self.features = tuple(features)
        self.num_domains = num_domains
        self.input_dim = sum_embed_dims(features)
        self.embedding = EmbeddingCollection(features, gen)

    def apply(self, x, train: bool = False, w=None, generator=None, rows=None):
        did = domain_ids(x)
        emb = self.embedding(x, self.features, squeeze_dim=True, rows=rows)
        ys = emb[None].expand((self.num_domains,) + tuple(emb.shape))
        return domain_select(ys[..., :1], did)
