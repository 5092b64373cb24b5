#!/usr/bin/env python3
"""Step 0 readings of the sorted dense-Adam kernel on one card: device ms
(the host kept out), host µs and launches per call, through
``chip_smoke.py``'s timer (``wrapper_cost``), each reading from one saved
state (repeated Adam passes shrink the moments and slow the pass).

The Ali-CCP shape (V = 10,741,000, D = 16, K = 94,208 uniform ids, 4096 a
feature), f32 and bf16 storage, hp by value: the unsharded form three times
each; and, where the tree has it, the row-sharded form
(``sorted_dense_adam_apply_sharded``) on every shard of E = 2 and 4, once
each. Random data from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/sorted_adam_step0.py [--seed N]
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sorted_adam_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops.kernels import _build
    from scenario_wise_rec_tpu_torch.ops.kernels import sorted_adam as sa

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    cs.log("built", _build.build(["sorted_adam"]))
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    r = np.random.default_rng(args.seed)
    V, D, K = cs.N_SPARSE * cs.VOCAB, 16, cs.N_SPARSE * cs.BATCH
    ids = cs.per_feature(lambda f: r.integers(0, cs.VOCAB, cs.BATCH)).cuda()
    g = 1e-3 * torch.randn(K, D, generator=gen, device="cuda")
    sid, gs = sa.owner_sorted_grads(ids, g)
    hp = sa.adam_hparams(3, 1e-3, 1e-5, 0.9, 0.999, 1e-8)
    sharded = hasattr(sa, "sorted_dense_adam_apply_sharded")
    out = {"tree": os.getcwd(), "card": card}
    for dt, name in ((torch.float32, "f32"), (torch.bfloat16, "bf16")):
        state = [torch.randn(V, D, generator=gen, device="cuda").to(dt),
                 (0.01 * torch.randn(V, D, generator=gen, device="cuda")).to(dt),
                 (1e-4 * torch.rand(V, D, generator=gen, device="cuda")).to(dt)]
        saved = [t.clone() for t in state]

        def restore():
            for t, t0 in zip(state, saved):
                t.copy_(t0)

        readings = []
        for _ in range(3):
            restore()
            readings.append(cs.wrapper_cost(f"{name} unsharded", lambda: sa.sorted_dense_adam_apply(
                *state, sid, gs, hp))["device_ms"])
        out[f"{name} unsharded"] = readings
        if sharded:
            for e in (2, 4):
                vl = V // e
                for j in range(e):
                    restore()
                    shard = [t[j * vl:(j + 1) * vl] for t in state]
                    out[f"{name} E={e} shard {j}"] = cs.wrapper_cost(
                        f"{name} E={e} shard {j}", lambda: sa.sorted_dense_adam_apply_sharded(
                            *shard, sid, gs, hp, row0=j * vl))["device_ms"]
        del state, saved
        torch.cuda.empty_cache()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
