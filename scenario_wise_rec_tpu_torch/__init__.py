"""scenario_wise_rec_tpu_torch — the PyTorch/CUDA port of scenario_wise_rec_tpu.

The same multi-scenario CTR framework written in PyTorch for an NVIDIA
Hopper card: ``nn.Module``s with stacked member axes, plain PyTorch for what
the JAX package left to XLA, and hand-written CUDA kernels (``csrc/``, bound
in ``ops/kernels/``) for what it wrote in Pallas. Entry points run on
``cuda`` unless the caller passes ``device="cpu"``.

The port imports neither JAX nor the JAX package.
"""

__version__ = "0.1.0"

from .core.config import set_parity_numerics

# The port compares with the JAX package in full f32: no TF32 anywhere.
set_parity_numerics()
