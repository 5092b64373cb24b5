"""Hand-written Hopper kernels and the plain PyTorch code around them.

- ``folding``: eval-time Linear→BatchNorm constant folding (plain torch; the
  precondition of the fused kernels).
- ``mmoe_infer``: the whole post-embedding MMOE eval stack in one CUDA
  kernel (``csrc/mmoe_infer.cu``), with its plain version.
- ``tower_infer``, ``ple_infer``, ``sarnet_infer``: the same for
  SharedBottom, PLE and SAR-Net (``csrc/{tower,ple,sarnet}_infer.cu``;
  SAR-Net's experts and gate as one product side by side);
- ``star_infer``: STAR's eval on SharedBottom's chain kernel
  (``csrc/tower_infer.cu``: its aux MLP and head, the domain norm in place,
  then its own domain's FCN, one domain a block, every product on the
  tensor cores);
- ``gated_infer``: the same for EPNet, PPNet and AdaSparse
  (``ppnet_fused_infer`` in ``csrc/ppnet_infer.cu``, each block on rows of
  one domain; ``adasparse_fused_infer`` in ``csrc/adasparse_infer.cu``,
  with ``adasparse_threshold_margin`` for comparing it across its hard
  threshold; ``epnet_fused_infer`` on the same kernel, two of its steps
  and the head);
- ``hamur_infer``: HAMUR's eval cut at its adapters' batch-statistics norms,
  one launch of the segment kernel ``hamur_segment`` (``csrc/hamur_infer.cu``)
  per segment, the hyper-network and the norms' statistics in PyTorch
  between them (``hamur_fused_infer``);
- ``adaptdhm_infer``: AdaptDHM's routed-cluster FCN on SharedBottom's
  chain kernel (``csrc/tower_infer.cu``, without a trunk and without
  biases: one cluster a block, every product on the tensor cores), with
  ``adaptdhm_route_margin`` for comparing it across a near-tie of the
  routing logits;
- ``m2m_infer``: M2M's eval after its transformer (``csrc/m2m_infer.cu``):
  the experts, the hyper-MLPs, the meta-attention over each row's generated
  matrix (a chunk of it at a time, never whole), the meta-tower and the
  output MLP, consecutive rows a block, every shared-weight product on the
  tensor cores;
- ``m3oe_infer``: M3oE's eval after the embedding (``csrc/m3oe_infer.cu``),
  a LayerNorm after every ``Mlp_N`` layer. Every fused eval kernel is built
  over ``csrc/mma_ring.cuh`` (PPNet's, M3oE's, PLE's, SharedBottom's and
  SAR-Net's, one domain a block, and AdaSparse's and M2M's also
  ``csrc/domain_tiles.cuh``). ``_fused`` holds the wrappers' shared Python
  side.
- ``sorted_adam``: the duplicate-id gradient sum and exact dense Adam over
  the whole embedding table in one CUDA kernel (``csrc/sorted_adam.cu``),
  with its plain version and the id sort; the ``sorted`` embedding update.
  The table and its moments are float32, or all bfloat16 (its bf16 form,
  ``sorted_dtype="bf16"``: the Adam math in f32, each result rounded).
  ``sorted_dense_adam_apply_sharded`` steps one row shard of a mesh's
  table from the whole batch's ids (the same kernel with the shard's
  first row).
- ``fused_adam``: the same from ids sorted within each feature's segment,
  the gradient rows read through their sorted positions
  (``csrc/fused_adam.cu``, ``fused_dense_adam_apply``); the ``dense``
  embedding update. ``fused_dense_adam_apply_sharded`` steps one row shard
  of a mesh's table likewise (the same kernel with the shard's first row).
  Both Adam kernels are built over the shared
  ``csrc/embedding_adam.cuh``.
- ``row_update``: the ``occurrence`` embedding update's two row primitives
  (``csrc/row_update.cu``): ``occurrence_segsum``, every occurrence's
  duplicate-id gradient sum, bit-identical across duplicates, and
  ``scatter_rows``, the in-place row write-back.
- ``_build``: compiles ``csrc/*.cu`` with nvcc at first use, loads with ctypes.

On a CPU tensor each wrapper runs its plain version; on a CUDA tensor it
launches its kernel or raises.

``FUSED_INFERENCE_WINS`` and :func:`fused_inference_auto` are the gate of
``CTRTrainer(fused_inference="auto")``: the model classes whose fused eval
served more examples a second than their op-by-op eval on the card.
"""

# The model classes whose fused predict pass outran the op-by-op one on an
# NVIDIA H100 80GB HBM3 at a 700.00 W power limit: the verdict of
# scripts/fused_auto_pairs.py over every sitting in its record
# (scripts/fused_auto_pairs_h100.json, 12 sittings from 5 runs), each
# model at Ali-CCP width with 467k ids per feature, predict over
# 8 * 4096 + 123 rows in batches of 4096, 6 runs a path a sitting. A class
# is in iff fused's median examples/s led op by op's in so many sittings
# that a one-sided sign test gives p < 0.05. EPNet and M2M led in 8 of 12
# (p 0.19): the card does not tell them apart, so they stay op by op, the
# reference path. `python3 scripts/fused_auto_pairs.py --sittings 0`
# reproduces the set from the record.
FUSED_INFERENCE_WINS = frozenset({
    "AdaSparse", "AdaptDHM", "HamurLarge", "HamurSmall", "M3oE", "MMOE", "PLE", "PPNet",
    "Sarnet", "SharedBottom", "Star"})


def fused_inference_auto(model) -> bool:
    """True iff ``model``'s class is in :data:`FUSED_INFERENCE_WINS` and it
    has a fused eval path (``apply_fused_eval``); the JAX package's rule."""
    return type(model).__name__ in FUSED_INFERENCE_WINS and hasattr(model, "apply_fused_eval")


from .adaptdhm_infer import (adaptdhm_fused_infer, adaptdhm_fused_infer_ref,
                             adaptdhm_route_margin)
from .folding import fold_bn_linear_eval, fold_layers_eval, fold_stacked_mlp_eval
from .fused_adam import (fused_dense_adam_apply, fused_dense_adam_apply_sharded,
                         fused_dense_adam_apply_sharded_ref, fused_dense_adam_ref)
from .gated_infer import (adasparse_fused_infer, adasparse_fused_infer_ref,
                          adasparse_threshold_margin, epnet_fused_infer,
                          epnet_fused_infer_ref, ppnet_fused_infer, ppnet_fused_infer_ref)
from .hamur_infer import (adapter_norm_affine, hamur_fused_infer, hamur_fused_infer_ref,
                          hamur_hyper, hamur_segment, hamur_segment_ref)
from .m2m_infer import m2m_fused_infer, m2m_fused_infer_ref
from .m3oe_infer import m3oe_fused_infer, m3oe_fused_infer_ref
from .mmoe_infer import mmoe_fused_infer, mmoe_fused_infer_ref
from .ple_infer import LevelSpec, ple_fused_infer, ple_fused_infer_ref
from .row_update import (occurrence_segsum, occurrence_segsum_ref, scatter_rows,
                         scatter_rows_ref)
from .sarnet_infer import sarnet_fused_infer, sarnet_fused_infer_ref
from .star_infer import star_fused_infer, star_fused_infer_ref
from .tower_infer import trunk_towers_fused_infer, trunk_towers_fused_infer_ref
from .sorted_adam import (owner_sorted_grads, sorted_dense_adam_apply,
                          sorted_dense_adam_apply_ref, sorted_dense_adam_apply_sharded,
                          sorted_dense_adam_apply_sharded_ref)

__all__ = ["FUSED_INFERENCE_WINS", "LevelSpec", "adaptdhm_fused_infer", "adaptdhm_fused_infer_ref",
           "adaptdhm_route_margin",
           "adapter_norm_affine", "adasparse_fused_infer", "adasparse_fused_infer_ref",
           "adasparse_threshold_margin", "epnet_fused_infer", "epnet_fused_infer_ref",
           "fold_bn_linear_eval", "fold_layers_eval", "fold_stacked_mlp_eval",
           "fused_dense_adam_apply", "fused_dense_adam_apply_sharded",
           "fused_dense_adam_apply_sharded_ref", "fused_inference_auto", "fused_dense_adam_ref",
           "hamur_fused_infer", "hamur_fused_infer_ref", "hamur_hyper", "hamur_segment",
           "hamur_segment_ref", "m2m_fused_infer", "m2m_fused_infer_ref", "m3oe_fused_infer",
           "m3oe_fused_infer_ref", "mmoe_fused_infer", "mmoe_fused_infer_ref",
           "occurrence_segsum", "occurrence_segsum_ref", "owner_sorted_grads",
           "ple_fused_infer", "ple_fused_infer_ref", "ppnet_fused_infer",
           "ppnet_fused_infer_ref", "sarnet_fused_infer", "sarnet_fused_infer_ref",
           "scatter_rows", "scatter_rows_ref",
           "sorted_dense_adam_apply", "sorted_dense_adam_apply_ref",
           "sorted_dense_adam_apply_sharded", "sorted_dense_adam_apply_sharded_ref", "star_fused_infer",
           "star_fused_infer_ref", "trunk_towers_fused_infer",
           "trunk_towers_fused_infer_ref"]
