"""Global compute configuration and device resolution.

``compute_dtype``: when set to ``torch.bfloat16``, :func:`matmul` and
:func:`einsum` round their operands to bf16 and return the f32 accumulation
of the rounded operands, as the JAX package's ``preferred_element_type=f32``
products do: the rounded operands are upcast to f32 and multiplied in f32
(TF32 off, see below), where each product of two bf16 values is exact.
Parameters stay f32. Default ``None`` keeps full f32 everywhere, the parity
configuration, and leaves the products untouched.

Parity numerics: a float32 matrix product on the card may run in TF32 if
``torch.backends.cuda.matmul.allow_tf32`` is set, and a float32 convolution
does by default through cuDNN. :func:`set_parity_numerics` turns both off;
the package calls it on import so the port compares with the JAX package
in full f32.
"""

from __future__ import annotations

from typing import Optional

import torch

_compute_dtype: Optional[torch.dtype] = None


def set_compute_dtype(dtype: Optional[torch.dtype]) -> None:
    global _compute_dtype
    _compute_dtype = dtype


def get_compute_dtype() -> Optional[torch.dtype]:
    return _compute_dtype


def set_parity_numerics() -> None:
    """Full f32 products: TF32 off for cuBLAS matmuls and for cuDNN."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rounded(t: torch.Tensor) -> torch.Tensor:
    """``t`` rounded to the compute dtype and back to f32."""
    return t.to(_compute_dtype).float()


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x @ w honoring the compute dtype (f32 accumulation)."""
    if _compute_dtype is not None:
        return torch.matmul(_rounded(x), _rounded(w))
    return torch.matmul(x, w)


def einsum(spec: str, *args: torch.Tensor) -> torch.Tensor:
    """einsum honoring the compute dtype (f32 accumulation)."""
    if _compute_dtype is not None:
        return torch.einsum(spec, *(_rounded(a) for a in args))
    return torch.einsum(spec, *args)


def resolve_device(device) -> torch.device:
    """``None`` means the card. A CUDA device with no card present raises:
    the port never moves to the CPU unless the caller asks for it."""
    dev = torch.device("cuda" if device is None or device == "" else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


def make_generator(device: torch.device, seed: int = 0) -> torch.Generator:
    """A seeded ``torch.Generator`` on ``device`` (initialisers draw from it)."""
    return torch.Generator(device=device).manual_seed(int(seed))
