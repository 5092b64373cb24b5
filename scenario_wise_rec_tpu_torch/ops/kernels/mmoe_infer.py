"""Fused MMOE inference: the CUDA kernel ``csrc/mmoe_infer.cu`` and its plain
PyTorch version.

The eval forward of MMOE after the embedding is a stack of small dense ops:
E relu expert MLPs, D softmax gates, the gate-weighted mixture, D relu
towers with a 1-unit head, sigmoid, per-row domain select. Run op by op,
every stage round-trips activations through device memory and pays a
launch; the kernel runs the whole stack for a tile of rows on chip: the
expert layers on the tensor cores in 3xTF32 (about f32's accuracy), the
weights streamed through shared memory (the design note is at the top of
the source). It replaces the TPU kernel
``scenario_wise_rec_tpu/ops/pallas/mmoe_infer.py:mmoe_fused_infer``.

Preconditions: eval mode (BatchNorm folded to affine, see ``folding.py``),
relu expert/tower activations, softmax gates.

:func:`mmoe_fused_infer` takes the plain version for a tensor on the CPU
and launches the kernel for one on a CUDA device, or raises; it never falls
back. ``mmoe_fused_infer.launches`` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch

from ._fused import check_batch, ints, ptrs

Affine = Tuple[torch.Tensor, torch.Tensor]

MAX_STAGES = 8    # expert and tower depth the kernel takes (csrc kMaxStages)
MAX_EXPERTS = 16  # csrc kMaxExperts
ROW_TILE = 16     # rows of one mma m-tile: block_rows is a multiple of it
MAX_BLOCK_ROWS = 64  # csrc kMaxMT m-tiles


def _check_shapes(emb, domain_id, expert_stages, gate_stage, tower_stages,
                  tower_out):
    B, F = check_batch(emb, domain_id)
    if not expert_stages:
        raise ValueError("need at least one expert stage")
    E = expert_stages[0][0].shape[0]
    D = gate_stage[0].shape[0]
    width = F
    for w, b in expert_stages:
        if w.shape[:2] != (E, width) or b.shape != (E, w.shape[2]):
            raise ValueError(f"expert stage W {tuple(w.shape)} b {tuple(b.shape)} "
                             f"does not follow width {width} with {E} experts")
        width = w.shape[2]
    if gate_stage[0].shape != (D, F, E) or gate_stage[1].shape != (D, E):
        raise ValueError(f"gate must be W [{D}, {F}, {E}] b [{D}, {E}]")
    for w, b in tower_stages:
        if w.shape[:2] != (D, width) or b.shape != (D, w.shape[2]):
            raise ValueError(f"tower stage W {tuple(w.shape)} b {tuple(b.shape)} "
                             f"does not follow width {width} with {D} domains")
        width = w.shape[2]
    if tower_out[0].shape != (D, width, 1) or tower_out[1].shape != (D, 1):
        raise ValueError(f"head must be W [{D}, {width}, 1] b [{D}, 1]")
    return B, F, E, D


def check_block_rows(block_rows: int | None) -> None:
    """The kernel's tile rule: a multiple of 16 (one mma m-tile) up to 64, or
    None (the kernel's choice)."""
    if block_rows is None:
        return
    if (not isinstance(block_rows, int) or not ROW_TILE <= block_rows <= MAX_BLOCK_ROWS
            or block_rows % ROW_TILE):
        raise ValueError(f"block_rows must be a multiple of {ROW_TILE} from {ROW_TILE} "
                         f"to {MAX_BLOCK_ROWS}, got {block_rows!r}")


def mmoe_fused_infer_ref(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    expert_stages: Sequence[Affine],   # each (W[E,in,out], b[E,out])
    gate_stage: Affine,                # (W[D,in,E], b[D,E])
    tower_stages: Sequence[Affine],    # each (W[D,in,out], b[D,out])
    tower_out: Affine,                 # (W[D,h,1], b[D,1])
) -> torch.Tensor:
    """probs[B], the plain PyTorch version: loops over E and D with ``@``,
    softmax, sigmoid and a select of each row's domain."""
    _check_shapes(emb, domain_id, expert_stages, gate_stage, tower_stages,
                  tower_out)
    E = expert_stages[0][0].shape[0]
    gw, gb = gate_stage
    ow, ob = tower_out
    D = gw.shape[0]
    experts = []
    for e in range(E):
        h = emb
        for w, b in expert_stages:
            h = torch.relu(h @ w[e] + b[e])
        experts.append(h)  # [B, H]
    did = torch.clamp(domain_id.to(torch.int32).long(), 0, D - 1)
    out = torch.zeros(emb.shape[0], dtype=torch.float32, device=emb.device)
    for d in range(D):
        gate = torch.softmax(emb @ gw[d] + gb[d], dim=1)  # [B, E]
        mixed = gate[:, 0:1] * experts[0]
        for e in range(1, E):
            mixed = mixed + gate[:, e:e + 1] * experts[e]
        h = mixed
        for w, b in tower_stages:
            h = torch.relu(h @ w[d] + b[d])
        logit = (h @ ow[d] + ob[d])[:, 0]
        out = torch.where(did == d, torch.sigmoid(logit), out)
    return out


@functools.lru_cache(maxsize=None)
def _lib():
    from . import _build

    lib = _build.load("mmoe_infer")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mmoe_fused_infer_f32.argtypes = [
        p, p, i, p, i, i, i, i, i, p, p, p, p, p, i, p, p, p, p, p, i, p]
    lib.mmoe_fused_infer_f32.restype = ctypes.c_int
    lib.mmoe_fused_infer_smem_bytes.argtypes = [i, i, i, i, p, i, p, ctypes.c_size_t]
    lib.mmoe_fused_infer_smem_bytes.restype = ctypes.c_size_t
    return lib


def mmoe_fused_infer(
    emb: torch.Tensor,
    domain_id: torch.Tensor,
    expert_stages: Sequence[Affine],
    gate_stage: Affine,
    tower_stages: Sequence[Affine],
    tower_out: Affine,
    block_rows: int | None = None,
) -> torch.Tensor:
    """probs[B] = fused MMOE eval forward on the embedded batch ``emb``.

    ``block_rows``: rows one block owns on the card, a multiple of 16 up to
    64 whose activations fit in a block's shared memory beside the
    smallest weight ring (the ring takes what the tile leaves). None: 32,
    or 16 where a 32-row tile does not fit (F over about 1,200 to 1,700,
    by the expert widths). 32 was the fastest of 16-64 at the Ali-CCP
    shape, B = 4096, on an H100 SXM (``chip_smoke.py``'s sweep): 128
    blocks, one wave. On the CPU the plain version runs and the value only
    has to keep the tile rule, so that a call that would raise on the card
    raises there too.
    """
    check_block_rows(block_rows)
    if emb.device.type == "cpu":
        return mmoe_fused_infer_ref(emb, domain_id, expert_stages, gate_stage,
                                    tower_stages, tower_out)
    if emb.device.type != "cuda":
        raise ValueError(f"mmoe_fused_infer runs on cuda or cpu, not {emb.device}")
    B, F, E, D = _check_shapes(emb, domain_id, expert_stages, gate_stage,
                               tower_stages, tower_out)
    if len(expert_stages) > MAX_STAGES or len(tower_stages) > MAX_STAGES:
        raise ValueError(f"the kernel takes at most {MAX_STAGES} expert and "
                         f"{MAX_STAGES} tower stages")
    if E > MAX_EXPERTS:
        raise ValueError(f"the kernel takes at most {MAX_EXPERTS} experts, got {E}")
    weights = [t for s in expert_stages for t in s] + list(gate_stage) + \
        [t for s in tower_stages for t in s] + list(tower_out)
    for t in [emb, domain_id] + weights:
        if t.device != emb.device:
            raise ValueError(f"tensor on {t.device}, emb on {emb.device}")
        if not t.is_contiguous():
            raise ValueError("mmoe_fused_infer takes contiguous tensors")
    for t in [emb] + weights:
        if t.dtype != torch.float32:
            raise ValueError(f"mmoe_fused_infer takes float32, got {t.dtype}")

    out = torch.empty(B, dtype=torch.float32, device=emb.device)
    if B == 0:
        return out
    lib = _lib()
    # int64 ids (the trainer's) and int32 ids are read as they are
    did = domain_id if domain_id.dtype in (torch.int32, torch.int64) else \
        domain_id.to(torch.int32)
    ed = ints([F] + [w.shape[2] for w, _ in expert_stages])
    td = ints([ed[-1]] + [w.shape[2] for w, _ in tower_stages])
    stream = torch.cuda.current_stream(emb.device).cuda_stream
    with torch.cuda.device(emb.device):
        err = lib.mmoe_fused_infer_f32(
            emb.data_ptr(), did.data_ptr(), did.dtype == torch.int64, out.data_ptr(), B, F,
            E, D,
            len(expert_stages), ptrs([w for w, _ in expert_stages]),
            ptrs([b for _, b in expert_stages]), ed,
            gate_stage[0].data_ptr(), gate_stage[1].data_ptr(),
            len(tower_stages), ptrs([w for w, _ in tower_stages]),
            ptrs([b for _, b in tower_stages]), td,
            tower_out[0].data_ptr(), tower_out[1].data_ptr(), block_rows or 0,
            stream)
    if err != 0:
        rows = block_rows or ROW_TILE
        smem = lib.mmoe_fused_infer_smem_bytes(
            rows, F, E, len(expert_stages), ed, len(tower_stages), td, 0)
        raise RuntimeError(
            f"mmoe_fused_infer launch failed with cudaError {err} ({smem} bytes of "
            f"shared memory per block at least, block_rows={rows})")
    mmoe_fused_infer.launches += 1
    return out


mmoe_fused_infer.launches = 0
