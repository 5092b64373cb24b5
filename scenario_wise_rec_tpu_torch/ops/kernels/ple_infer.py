"""Fused PLE (CGC) inference: the CUDA kernel ``csrc/ple_infer.cu`` and its
plain PyTorch version.

PLE's eval forward after the embedding: per CGC level, the D·S specific
and n_sh shared relu expert MLPs, each domain's softmax gate over its own
specifics and the shared experts, and before the last level a shared
softmax gate over all experts; then each domain's relu tower and 1-unit
head, sigmoid, and each row's own domain selected. The kernel gives each
block rows of one domain, runs at the last level only what that domain
needs, and runs every product on the tensor cores in 3xTF32 (about f32's
accuracy), the weights streamed through shared memory (the design note is
at the top of the source). It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/ple_infer.py:ple_fused_infer``.

Preconditions: eval mode (BatchNorm folded to affine, see ``folding.py``),
relu experts and towers, softmax after every gate stage.

:func:`ple_fused_infer` takes the plain version for a tensor on the CPU and
launches the kernel for one on a CUDA device, or raises; it never falls
back. ``ple_fused_infer.launches`` counts launches.
"""

from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import torch

from . import _fused
from ._fused import Affine
from .mmoe_infer import ROW_TILE, check_block_rows

MAX_LEVELS = 4  # csrc kMaxLevels
# csrc kMaxSteps and kMaxMixes: the schedule is a kernel parameter
MAX_PRODUCTS = 256
MAX_MIXES = 256
MAX_DOMAINS = 256  # csrc kMaxDomains: the partition's counts in shared memory


class LevelSpec:
    """Folded affine stages of one CGC level.

    spec_stages:   each (W[D, S, in, out], b[D, S, out])
    shared_stages: each (W[n_sh, in, out], b[n_sh, out])
    gate_stages:   each (W[D, in, E], b[D, E]), a softmax after every stage
    gate_shared_stages: each (W[in, n_all], b[n_all]), or None on the last
                   level
    """

    def __init__(self, spec_stages: Sequence[Affine],
                 shared_stages: Sequence[Affine],
                 gate_stages: Sequence[Affine],
                 gate_shared_stages: Optional[Sequence[Affine]]):
        self.spec_stages = list(spec_stages)
        self.shared_stages = list(shared_stages)
        self.gate_stages = list(gate_stages)
        self.gate_shared_stages = (
            None if gate_shared_stages is None else list(gate_shared_stages))


def _check_shapes(emb, domain_id, levels, tower_stages, tower_out):
    B, F = _fused.check_batch(emb, domain_id)
    if not levels:
        raise ValueError("need at least one level")
    D = tower_out[0].shape[0]
    if not levels[0].spec_stages or not levels[0].shared_stages:
        raise ValueError("every level needs specific and shared expert stages")
    S = levels[0].spec_stages[0][0].shape[1]
    n_sh = levels[0].shared_stages[0][0].shape[0]
    E, n_all = S + n_sh, D * S + n_sh
    width = F
    for li, lv in enumerate(levels):
        last = li == len(levels) - 1
        if not lv.spec_stages or not lv.shared_stages or not lv.gate_stages:
            raise ValueError(f"level {li} needs specific, shared and gate stages")
        if last != (lv.gate_shared_stages is None) or (
                not last and not lv.gate_shared_stages):
            raise ValueError(f"level {li}: a shared gate belongs to every level "
                             "but the last")
        h = _fused.check_chain(f"level {li} specific", lv.spec_stages, (D, S), width)
        if _fused.check_chain(f"level {li} shared", lv.shared_stages, (n_sh,), width) != h:
            raise ValueError(f"level {li}: shared experts must end at width {h}")
        if _fused.check_chain(f"level {li} gate", lv.gate_stages, (D,), width) != E:
            raise ValueError(f"level {li}: the gates must end at width {E}")
        if not last and _fused.check_chain(f"level {li} shared gate",
                                           lv.gate_shared_stages, (), width) != n_all:
            raise ValueError(f"level {li}: the shared gate must end at width {n_all}")
        width = h
    width = _fused.check_chain("tower", tower_stages, (D,), width)
    _fused.check_chain("head", [tower_out], (D,), width)
    if tower_out[0].shape[-1] != 1:
        raise ValueError("the head must have width 1")
    return B, F, D, S, n_sh


def _flat_stages(levels, tower_stages, tower_out) -> List[Affine]:
    """Every stage in the one order the kernel reads them: per level its
    specific, shared, gate and shared-gate stages; the towers; the head."""
    flat: List[Affine] = []
    for lv in levels:
        flat += lv.spec_stages + lv.shared_stages + lv.gate_stages
        flat += lv.gate_shared_stages or []
    return flat + list(tower_stages) + [tower_out]


def ple_fused_infer_ref(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    levels: Sequence[LevelSpec],
    tower_stages: Sequence[Affine],    # each (W[D, in, out], b[D, out])
    tower_out: Affine,                 # (W[D, h, 1], b[D, 1])
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: every level's experts and gates
    for every domain with ``@``, the towers per domain, and a select of each
    row's domain (the TPU kernel's loops)."""
    _, _, D, S, n_sh = _check_shapes(emb, domain_id, levels, tower_stages, tower_out)
    streams = [emb] * D
    shared_in = emb
    for lv in levels:
        spec = []
        for d in range(D):
            per_d = []
            for s in range(S):
                h = streams[d]
                for w, b in lv.spec_stages:
                    h = torch.relu(h @ w[d, s] + b[d, s])
                per_d.append(h)
            spec.append(per_d)
        shared = []
        for j in range(n_sh):
            h = shared_in
            for w, b in lv.shared_stages:
                h = torch.relu(h @ w[j] + b[j])
            shared.append(h)
        mixed = []
        for d in range(D):
            g = streams[d]
            for w, b in lv.gate_stages:
                g = torch.softmax(g @ w[d] + b[d], dim=1)
            mixed.append(_fused.mix(g, spec[d] + shared))
        if lv.gate_shared_stages is not None:
            g = shared_in
            for w, b in lv.gate_shared_stages:
                g = torch.softmax(g @ w + b, dim=1)
            shared_in = _fused.mix(g, [x for per_d in spec for x in per_d] + shared)
        streams = mixed
    did = torch.clamp(domain_id.to(torch.int32).long(), 0, D - 1)
    out = torch.zeros(emb.shape[0], dtype=torch.float32, device=emb.device)
    for d in range(D):
        t = streams[d]
        for w, b in tower_stages:
            t = torch.relu(t @ w[d] + b[d])
        logit = (t @ tower_out[0][d] + tower_out[1][d])[:, 0]
        out = torch.where(did == d, torch.sigmoid(logit), out)
    return out


def _schedule_size(levels, D, S, n_sh, n_tower):
    """``(products, mixes)`` of the kernel's schedule: at the last level the
    row's own S specific experts, the shared ones and its own gate; before
    it every domain's experts and gates and the shared gate, each expert's
    output mixed into the streams it feeds; then the own tower."""
    products, mixes = n_tower, 0
    for li, lv in enumerate(levels):
        sp, sh, g = len(lv.spec_stages), len(lv.shared_stages), len(lv.gate_stages)
        if li == len(levels) - 1:
            products += S * sp + n_sh * sh + g
            mixes += S + n_sh
        else:
            products += D * S * sp + n_sh * sh + D * g + len(lv.gate_shared_stages)
            mixes += 2 * D * S + n_sh * (D + 1)
    return products, mixes


def ple_fused_infer(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    levels: Sequence[LevelSpec],
    tower_stages: Sequence[Affine],
    tower_out: Affine,
    block_rows: int | None = None,
) -> torch.Tensor:
    """probs[B] = fused PLE eval forward on the embedded batch ``emb``.

    ``block_rows``: rows of one domain that one block owns on the card, a
    multiple of 16 up to 64 whose tiles fit in a block's shared memory
    beside the smallest weight ring. None: 32, or 16 where a 32-row tile
    does not fit (at PLE's Ali-CCP widths 16, 32 and 48 fit at 1 level, 16
    and 32 at 2 levels; 64 does not). A shape whose tile does not fit raises
    a RuntimeError; it never falls back. On the CPU the plain version runs
    and the value only has to keep the tile rule, so that a call that would
    raise on the card for its ``block_rows`` raises there too. The card
    takes at most ``MAX_LEVELS`` levels, ``MAX_DOMAINS`` domains and a
    schedule of ``MAX_PRODUCTS`` products and ``MAX_MIXES`` mixes (see
    :func:`_schedule_size`; Ali-CCP's expert ladder takes 20 and 3 at 1
    level, 158 and 51 at 4). int32 and int64 domain ids are read as they
    are.
    """
    check_block_rows(block_rows)
    if emb.device.type == "cpu":
        return ple_fused_infer_ref(emb, domain_id, levels, tower_stages, tower_out)
    B, F, D, S, n_sh = _check_shapes(emb, domain_id, levels, tower_stages, tower_out)
    if len(levels) > MAX_LEVELS:
        raise ValueError(f"ple_fused_infer takes at most {MAX_LEVELS} levels")
    if D > MAX_DOMAINS:
        raise ValueError(f"ple_fused_infer takes at most {MAX_DOMAINS} domains, got {D}")
    products, mixes = _schedule_size(levels, D, S, n_sh, len(tower_stages))
    if products > MAX_PRODUCTS or mixes > MAX_MIXES:
        raise ValueError(f"ple_fused_infer takes at most {MAX_PRODUCTS} products and "
                         f"{MAX_MIXES} mixes a launch, got {products} and {mixes}")
    stages = _flat_stages(levels, tower_stages, tower_out)
    _fused.check_tensors("ple_fused_infer", emb, domain_id, [t for s in stages for t in s])
    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    counts = _fused.ints([n for lv in levels for n in (
        len(lv.spec_stages), len(lv.shared_stages), len(lv.gate_stages),
        len(lv.gate_shared_stages or []))])
    did = domain_id if domain_id.dtype in (torch.int32, torch.int64) else \
        domain_id.to(torch.int32)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn = _fused.function("ple_infer", "ple_fused_infer_f32",
                         (p, p, i, p, i, i, i, i, i, i, p, i, p, p, p))
    smem = ctypes.c_size_t(0)
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    with torch.cuda.device(emb.device):
        err = fn(emb.data_ptr(), did.data_ptr(), did.dtype == torch.int64, out.data_ptr(), B,
                 F, D, S, n_sh, len(levels), counts, len(tower_stages),
                 *_fused.stage_args(stages), block_rows or 0, stream, ctypes.byref(smem))
    if err != 0:
        raise RuntimeError(
            f"ple_fused_infer launch failed with cudaError {err} ({smem.value} bytes of "
            f"shared memory per block, block_rows={block_rows or ROW_TILE})")
    ple_fused_infer.launches += 1
    return out


ple_fused_infer.launches = 0
