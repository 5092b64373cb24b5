#!/usr/bin/env python3
"""Step 0 readings of PLE's eval kernel on one card: device ms (the host
kept out), host µs and launches per call, through ``chip_smoke.py``'s timer
(``wrapper_cost``), each call first held to its plain version (1e-5).

PLE at Ali-CCP, B = 4096 (F = 376, 3 domains, 2 specific and 1 shared
experts [256, 128, 64, 32, 16, 8], gates 376 -> 3, tower [16]): at 1 level
with int64 ids (as ``chip_smoke.py`` and the trainer pass them) and int32
ids, at the wrapper's default tile and at ``block_rows`` 16, 32, 48 and 64;
at 2 levels (the shared gate's path) with int64 ids at the default tile and
at 16, 32 and 48 rows (a tile that a tree does not take, or that does not
fit, is logged as such). Then, with int64 ids at the default tile, where
the time goes: B = 65,536 (the partition by domain grows with B^2), and the
experts cut to width 8 (their six products a chain 8 wide, 97 % of a
row's multiply-adds gone, every step kept). Random weights and inputs from
``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/ple_step0.py [--seed N]
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
        print("ple_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    source = cs.EVAL_KERNELS["ple"][1]
    cs.log("built", _build.build([source]))
    for line in _build.build_logs.get(source, "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    F, D, S, n_sh = cs.N_SPARSE * 16 + cs.N_DENSE, cs.DOMAINS, 2, 1

    def weights(dims, n_level):
        out, width = [], F
        for i in range(n_level):
            gs = None if i == n_level - 1 else cs.affines(gen, (), [width, D * S + n_sh])
            out.append(k.LevelSpec(cs.affines(gen, (D, S), [width] + dims),
                                   cs.affines(gen, (n_sh,), [width] + dims),
                                   cs.affines(gen, (D,), [width, S + n_sh]), gs))
            width = dims[-1]
        tw = cs.affines(gen, (D,), [width] + cs.TOWER_DIMS)
        return out, tw, cs.affines(gen, (D,), [cs.TOWER_DIMS[-1], 1])[0]

    def reading(label, emb, ids, stages, **tile):
        want = k.ple_fused_infer_ref(emb, ids, *stages)
        try:
            got = k.ple_fused_infer(emb, ids, *stages, **tile)
        except (RuntimeError, ValueError) as e:  # a tile this tree does not take
            cs.log(f"    {label}: {str(e)[:160]}")
            return None
        err = (got - want).abs().max().item()
        cs.check(err <= cs.TOL, f"{label} disagrees with plain ({err})")
        c = cs.wrapper_cost(f"{label} (max_abs_err {err:.3e})",
                            lambda: k.ple_fused_infer(emb, ids, *stages, **tile))
        return [c["device_ms"], c["host_us"], c["launches_per_call"]]

    ali = weights(cs.EXPERT_DIMS, 1)
    two = weights(cs.EXPERT_DIMS, 2)
    emb = torch.randn(4096, F, generator=gen, device="cuda")
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    out = {"card": card}
    for rep in range(2):
        for rows in (None, 16, 32, 48, 64):
            tile = {} if rows is None else {"block_rows": rows}  # None: the default
            for ids in (did, did.to(torch.int32)):
                label = f"{str(ids.dtype).split('.')[-1]} ids, block_rows={rows}"
                out[f"rep{rep} {label}"] = reading(f"rep {rep} {label}", emb, ids, ali, **tile)
        for rows in (None, 16, 32, 48):
            tile = {} if rows is None else {"block_rows": rows}
            label = f"2 levels, int64 ids, block_rows={rows}"
            out[f"rep{rep} {label}"] = reading(f"rep {rep} {label}", emb, did, two, **tile)
    big = torch.randn(65_536, F, generator=gen, device="cuda")
    big_ids = torch.randint(0, D, (65_536,), generator=gen, device="cuda")
    out["b65536"] = reading("B 65,536", big, big_ids, ali)
    out["experts8"] = reading("the experts 8 wide", emb, did, weights([8] * 6, 1))
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
