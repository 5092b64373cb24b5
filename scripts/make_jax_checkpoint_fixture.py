"""Write the JAX-written checkpoint fixture that the port's tests read.

With the JAX package, a narrow MMOE (3 domains, 3 sparse features of width
16 and one dense feature, experts [16, 8], towers [4]) takes two sorted-mode
train steps (f32 storage, ``sorted_block_rows=64``) and is saved by
``CTRTrainer.save``; a fixed batch and the JAX trainer's probabilities on it
are written beside it:

- ``jax_mmoe_sorted.json``: the features, model and trainer keywords, so
  that a reader without JAX builds the same model;
- ``jax_mmoe_sorted.npz``: the checkpoint, in the JAX package's format;
- ``jax_mmoe_sorted_batch.npz``: the batch's columns and ``__prob__``.

Everything is drawn from a fixed seed on the CPU. The committed copy lives
in ``tests/data/`` (under 100 KB); ``tests/test_torch_port_jax_checkpoint.py``
regenerates it and holds the committed probabilities to 1e-5, and loads it
into the port (the card tests and ``chip_smoke.py`` on the card).

    JAX_PLATFORMS=cpu python scripts/make_jax_checkpoint_fixture.py [OUT_DIR]
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))

NAME = "jax_mmoe_sorted"
SPEC = {
    "model": "MMOE",
    "domain_num": 3,
    "embed_dim": 16,
    "sparse": [["s0", 40], ["s1", 45], ["s2", 50]],
    "dense": ["d0"],
    "model_kwargs": {"n_expert": 2, "expert_params": {"dims": [16, 8]},
                     "tower_params": {"dims": [4]}},
    "trainer_kwargs": {"sparse_embedding_updates": True, "sparse_update_impl": "sorted"},
    "jax_trainer_kwargs": {"sorted_block_rows": 64},
    "seed": 5,
    "batch_rows": 64,
}


def batch(seed, rows, spec=SPEC):
    """``(x, y)`` of ``rows`` rows drawn from ``seed`` in the spec's schema."""
    r = np.random.default_rng(seed)
    x = {n: r.integers(0, v, rows).astype(np.int32) for n, v in spec["sparse"]}
    for n in spec["dense"]:
        x[n] = r.normal(size=rows).astype(np.float32)
    x["domain_indicator"] = r.integers(0, spec["domain_num"], rows).astype(np.int32)
    return x, r.integers(0, 2, rows).astype(np.float32)


def main(out_dir=os.path.normpath(os.path.join(HERE, "..", "tests", "data"))):
    import jax
    import jax.numpy as jnp

    from scenario_wise_rec_tpu.core import DenseFeature, SparseFeature
    from scenario_wise_rec_tpu.data import dataset as jds
    from scenario_wise_rec_tpu.models import MMOE
    from scenario_wise_rec_tpu.train import CTRTrainer

    feats = ([SparseFeature(n, vocab_size=v, embed_dim=SPEC["embed_dim"])
              for n, v in SPEC["sparse"]] + [DenseFeature(n) for n in SPEC["dense"]])
    trainer = CTRTrainer(MMOE(feats, SPEC["domain_num"], **SPEC["model_kwargs"]),
                         seed=SPEC["seed"], **SPEC["trainer_kwargs"],
                         **SPEC["jax_trainer_kwargs"])
    rows = SPEC["batch_rows"]
    for step in range(2):
        x, y = batch(SPEC["seed"] + 1 + step, rows)
        xb = {k: jnp.asarray(v) for k, v in x.items()}
        trainer.params, trainer.opt_state, trainer.state, _ = trainer._train_step(
            trainer.params, trainer.opt_state, trainer.state, xb, jnp.asarray(y),
            jnp.ones(rows, jnp.float32), jax.random.PRNGKey(step))
    os.makedirs(out_dir, exist_ok=True)
    trainer.save(os.path.join(out_dir, NAME))
    x, _ = batch(SPEC["seed"] + 10, rows)
    prob = np.asarray(trainer.predict(trainer.model, jds.PredictIterable(x, rows)), np.float32)
    np.savez(os.path.join(out_dir, NAME + "_batch.npz"), __prob__=prob, **x)
    with open(os.path.join(out_dir, NAME + ".json"), "w") as f:
        json.dump(SPEC, f, indent=1)
    print(f"wrote {NAME}.json, {NAME}.npz and {NAME}_batch.npz under {out_dir}; "
          f"probabilities {prob[:4]} ...")
    return out_dir


if __name__ == "__main__":
    main(*sys.argv[1:])
