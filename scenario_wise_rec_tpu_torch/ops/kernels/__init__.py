"""Hand-written Hopper kernels and the plain PyTorch code around them.

- ``folding``: eval-time Linear→BatchNorm constant folding (plain torch; the
  precondition of the fused kernels).
- ``mmoe_infer``: the whole post-embedding MMOE eval stack in one CUDA
  kernel (``csrc/mmoe_infer.cu``), with its plain version.
- ``sorted_adam``: the duplicate-id gradient sum and exact dense Adam over
  the whole embedding table in one CUDA kernel (``csrc/sorted_adam.cu``),
  with its plain version and the id sort.
- ``_build``: compiles ``csrc/*.cu`` with nvcc at first use, loads with ctypes.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from .folding import fold_bn_linear_eval, fold_stacked_mlp_eval
from .mmoe_infer import mmoe_fused_infer, mmoe_fused_infer_ref
from .sorted_adam import (owner_sorted_grads, sorted_dense_adam_apply,
                          sorted_dense_adam_apply_ref)

__all__ = ["fold_bn_linear_eval", "fold_stacked_mlp_eval",
           "mmoe_fused_infer", "mmoe_fused_infer_ref", "owner_sorted_grads",
           "sorted_dense_adam_apply", "sorted_dense_adam_apply_ref"]
