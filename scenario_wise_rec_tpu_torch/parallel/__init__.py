"""Multi-GPU training on a ``(data, embed)`` process mesh (the JAX package's
``parallel/``): ``mesh`` (process group, mesh, collectives, batch shards,
the step context), ``sharding_rules`` (what is row-sharded) and
``sharded_embedding`` (the row-sharded lookup)."""

from .mesh import (Mesh, current_step, init_distributed, make_mesh, mesh_step, replicate,
                   shard_batch_fn, shard_stacked_batch_fn)
from .sharded_embedding import make_sharded_lookup_fn, pad_vocab, sharded_lookup
from .sharding_rules import gather_rows, param_specs, shard_range, shard_rows

__all__ = ["Mesh", "current_step", "gather_rows", "init_distributed", "make_mesh",
           "make_sharded_lookup_fn", "mesh_step", "pad_vocab", "param_specs", "replicate",
           "shard_batch_fn", "shard_range", "shard_rows", "shard_stacked_batch_fn",
           "sharded_lookup"]
