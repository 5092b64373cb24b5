#!/usr/bin/env python3
"""Step 0 readings of AdaptDHM's eval kernel on one card: device ms (the host
kept out), host µs and launches per call, through ``chip_smoke.py``'s timer
(``wrapper_cost``), each call first held to its plain version (1e-5).

AdaptDHM at Ali-CCP, B = 4096 (the scenario loader: F = 22 x 16 + 16 = 368,
3 clusters, stages [256, 128, 64, 32, 16, 8], then 8 -> 1, no bias): with
int64 router ids (``argmax``'s, as the model passes them) and int32 ids, at
the wrapper's default tile and at ``block_rows`` 16, 32, 48 and 64 (a tile
that a tree does not take, or that does not fit, is logged as such). Then,
with int64 ids at the default tile: B = 65,536 and KuaiRand's ladder (F 812:
796 sparse columns and the scenario feature's 16, 3 clusters, [64, 64]).
Random weights and inputs from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/adaptdhm_step0.py [--seed N]
"""

import argparse
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("adaptdhm_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    source = cs.EVAL_KERNELS["adaptdhm"][1]
    cs.log("built", _build.build([source]))
    for line in _build.build_logs.get(source, "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    D = cs.DOMAINS

    def weights(Fi, C, dims):
        return [w for w, _ in cs.affines(gen, (C,), [Fi] + dims + [1])]

    def reading(label, emb, ids, stages, **tile):
        want = k.adaptdhm_fused_infer_ref(emb, ids, stages)
        try:
            got = k.adaptdhm_fused_infer(emb, ids, stages, **tile)
        except (RuntimeError, ValueError) as e:  # a tile this tree does not take
            cs.log(f"    {label}: {str(e)[:160]}")
            return None
        err = (got - want).abs().max().item()
        cs.check(err <= cs.TOL, f"{label} disagrees with plain ({err})")
        c = cs.wrapper_cost(f"{label} (max_abs_err {err:.3e})",
                            lambda: k.adaptdhm_fused_infer(emb, ids, stages, **tile))
        return [c["device_ms"], c["host_us"], c["launches_per_call"]]

    F = (cs.N_SPARSE - 1) * 16 + 16
    ali = weights(F, D, cs.EXPERT_DIMS)
    emb = torch.randn(4096, F, generator=gen, device="cuda")
    rid = torch.argmax(torch.randn(4096, D, generator=gen, device="cuda"), dim=1)
    out = {"card": card}
    for rep in range(2):
        for rows in (None, 16, 32, 48, 64):
            tile = {} if rows is None else {"block_rows": rows}  # None: the default
            for ids in (rid, rid.to(torch.int32)):
                label = f"{str(ids.dtype).split('.')[-1]} ids, block_rows={rows}"
                out[f"rep{rep} {label}"] = reading(f"rep {rep} {label}", emb, ids, ali, **tile)
    big = torch.randn(65_536, F, generator=gen, device="cuda")
    big_ids = torch.randint(0, D, (65_536,), generator=gen, device="cuda")
    out["b65536"] = reading("B 65,536", big, big_ids, ali)
    x = torch.randn(4096, 812, generator=gen, device="cuda")
    x_ids = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    out["kuairand"] = reading("kuairand's ladder", x, x_ids, weights(812, D, [64, 64]))
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
