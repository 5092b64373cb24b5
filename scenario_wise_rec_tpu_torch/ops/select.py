"""Per-row domain selection.

The reference computes every domain branch on the full batch, then
``final = where(domain_id == d, y_d, final)`` in a Python loop. With branch
outputs stacked on a leading domain axis this is a single gather.
"""

from __future__ import annotations

import torch


def domain_select(ys: torch.Tensor, domain_id: torch.Tensor) -> torch.Tensor:
    """Select ``ys[domain_id[b], b]`` per row.

    Args:
        ys: ``[D, B]`` or ``[D, B, 1]`` stacked per-domain outputs.
        domain_id: ``[B]`` int domain indicator, clipped to ``[0, D-1]``.

    Returns: ``[B]``.
    """
    if ys.ndim == 3:
        ys = ys[..., 0]
    d = torch.clamp(domain_id.to(torch.int32).long(), 0, ys.shape[0] - 1)
    return torch.gather(ys.t(), 1, d[:, None])[:, 0]
