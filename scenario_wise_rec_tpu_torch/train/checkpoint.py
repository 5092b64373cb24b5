"""Checkpoint save/restore: path-keyed tensors in one ``.npz`` (the JAX
package's ``train/checkpoint.py``).

A checkpoint is a flat ``{path: tensor}`` dict written as numpy arrays, plus
JSON metadata under ``__metadata__``. No pickle is written or read
(``allow_pickle=False``), so a checkpoint is portable across hosts and safe
to open. The reference can only ``torch.save`` a final state dict and has no
load path (ctr_trainer.py:94-97).

numpy has no bfloat16, so a bfloat16 tensor (the sorted mode's bf16
moments) is stored as its raw ``uint16`` bits with its key listed in
``__bf16__``, as the JAX package's format stores its bfloat16 leaves, and
viewed back as bfloat16 on load. This is the port's own format; reading a
checkpoint the JAX package wrote (sorted-mode packed tiles) is not supported
yet.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple

import numpy as np
import torch


def npz_path(path: str) -> str:
    """``path`` with ``.npz`` appended unless it ends so."""
    return path if path.endswith(".npz") else path + ".npz"


def save(path: str, tensors: Dict[str, torch.Tensor],
         metadata: Dict[str, Any] | None = None) -> str:
    """Write ``tensors`` (+ JSON-able ``metadata``) to ``path`` (``.npz``
    appended). Returns the file's path."""
    if set(tensors) & {"__metadata__", "__bf16__"}:
        raise ValueError("'__metadata__' and '__bf16__' are reserved")
    flat, bf16 = {}, []
    for k, v in tensors.items():
        v = v.detach().cpu()
        if v.dtype == torch.bfloat16:
            flat[k] = v.view(torch.int16).numpy().view(np.uint16)
            bf16.append(k)
        else:
            flat[k] = v.numpy()
    flat["__bf16__"] = np.frombuffer(json.dumps(bf16).encode(), dtype=np.uint8)
    flat["__metadata__"] = np.frombuffer(json.dumps(metadata or {}).encode(),
                                         dtype=np.uint8)
    out = npz_path(path)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    np.savez(out, **flat)
    return out


def read_metadata(path: str) -> Dict[str, Any]:
    """Only the JSON metadata (npz members load lazily), so a caller can
    check compatibility before it reads the tensors."""
    with np.load(npz_path(path), allow_pickle=False) as data:
        if "__metadata__" not in data:
            return {}
        return json.loads(bytes(data["__metadata__"]).decode())


def load(path: str, expected: Dict[str, torch.Tensor]
         ) -> Tuple[Dict[str, torch.Tensor], Dict[str, Any]]:
    """``(tensors, metadata)``: CPU tensors for exactly the keys of
    ``expected``, each checked against the expected tensor's shape and
    against whether it is bfloat16; a missing key or a mismatch raises."""
    with np.load(npz_path(path), allow_pickle=False) as data:
        meta = (json.loads(bytes(data["__metadata__"]).decode())
                if "__metadata__" in data else {})
        bf16 = (set(json.loads(bytes(data["__bf16__"]).decode()))
                if "__bf16__" in data else set())
        out = {}
        for key, ref in expected.items():
            if key not in data:
                raise KeyError(f"checkpoint {path} has no entry {key}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"checkpoint entry {key}: shape {arr.shape} != "
                                 f"expected {tuple(ref.shape)}")
            if (key in bf16) != (ref.dtype == torch.bfloat16):
                raise ValueError(f"checkpoint entry {key}: "
                                 f"{'bfloat16' if key in bf16 else arr.dtype} where "
                                 f"{ref.dtype} is expected")
            out[key] = (torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
                        if key in bf16 else torch.from_numpy(arr))
    return out, meta
