"""Hand-written Hopper kernels and the plain PyTorch code around them.

- ``folding``: eval-time Linear→BatchNorm constant folding (plain torch; the
  precondition of the fused kernels).
- ``mmoe_infer``: the whole post-embedding MMOE eval stack in one CUDA
  kernel (``csrc/mmoe_infer.cu``), with its plain version.
- ``tower_infer``, ``star_infer``, ``ple_infer``: the same for
  SharedBottom, STAR and PLE (``csrc/{tower,star,ple}_infer.cu`` over the
  shared ``csrc/fused_mlp.cuh``; ``_fused`` holds their Python side).
- ``sorted_adam``: the duplicate-id gradient sum and exact dense Adam over
  the whole embedding table in one CUDA kernel (``csrc/sorted_adam.cu``),
  with its plain version and the id sort.
- ``_build``: compiles ``csrc/*.cu`` with nvcc at first use, loads with ctypes.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.
"""

from .folding import fold_bn_linear_eval, fold_stacked_mlp_eval
from .mmoe_infer import mmoe_fused_infer, mmoe_fused_infer_ref
from .ple_infer import LevelSpec, ple_fused_infer, ple_fused_infer_ref
from .star_infer import star_fused_infer, star_fused_infer_ref
from .tower_infer import trunk_towers_fused_infer, trunk_towers_fused_infer_ref
from .sorted_adam import (owner_sorted_grads, sorted_dense_adam_apply,
                          sorted_dense_adam_apply_ref)

__all__ = ["LevelSpec", "fold_bn_linear_eval", "fold_stacked_mlp_eval",
           "mmoe_fused_infer", "mmoe_fused_infer_ref", "owner_sorted_grads",
           "ple_fused_infer", "ple_fused_infer_ref", "sorted_dense_adam_apply",
           "sorted_dense_adam_apply_ref", "star_fused_infer", "star_fused_infer_ref",
           "trunk_towers_fused_infer", "trunk_towers_fused_infer_ref"]
