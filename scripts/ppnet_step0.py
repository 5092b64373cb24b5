#!/usr/bin/env python3
"""Step 0 readings of PPNet's eval kernel on one card: device ms (the host
kept out), host µs and launches per call, through ``chip_smoke.py``'s timer
(``wrapper_cost``), each call first held to its plain version (1e-5).

PPNet at Ali-CCP, B = 4096 (G = 376, 3 domains, layers [256, 128, 64, 32,
16, 8], each with its gate): int64 ids at the wrapper's default tile (as
``chip_smoke.py`` reads it), int32 ids (as the model passes them) at the
default tile and at ``block_rows`` 16, 32 and 48, the tiles every tree of
the kernel takes. Then, at the default tile with int32 ids, where the time
goes: B = 65,536 (the partition by domain grows with B^2) and the tower cut
to its first three layers and to its first one. Random weights and inputs
from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/ppnet_step0.py [--seed N]
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
        print("ppnet_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    source = cs.EVAL_KERNELS["ppnet"][1]
    cs.log("built", _build.build([source]))
    for line in _build.build_logs.get(source, "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    G, D, dims = 2 * 16 + (cs.N_SPARSE - 3) * 16 + cs.N_DENSE + 16, cs.DOMAINS, cs.EXPERT_DIMS
    stages = (cs.affines(gen, (D,), [G] + dims),
              [cs.affines(gen, (D,), [G, o])[0] for o in dims],
              [cs.affines(gen, (D,), [o, o])[0] for o in dims],
              cs.affines(gen, (D,), [dims[-1], 1])[0], 2.0)
    g = torch.randn(4096, G, generator=gen, device="cuda")
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    want = k.ppnet_fused_infer_ref(g, did, *stages)
    out = {"card": card}
    for rep in range(2):
        for ids, rows in ((did, None), (did.to(torch.int32), None),
                          *((did.to(torch.int32), r) for r in (16, 32, 48))):
            tile = {} if rows is None else {"block_rows": rows}  # None: the wrapper's default
            err = (k.ppnet_fused_infer(g, ids, *stages, **tile) - want).abs().max().item()
            cs.check(err <= cs.TOL, f"block_rows={rows} disagrees with plain ({err})")
            label = f"{str(ids.dtype).split('.')[-1]} ids, block_rows={rows}"
            c = cs.wrapper_cost(f"rep {rep} {label} (max_abs_err {err:.3e})",
                                lambda: k.ppnet_fused_infer(g, ids, *stages, **tile))
            out[f"rep{rep} {label}"] = [c["device_ms"], c["host_us"], c["launches_per_call"]]
    big = torch.randn(65_536, G, generator=gen, device="cuda")
    big_ids = torch.randint(0, D, (65_536,), generator=gen, device="cuda", dtype=torch.int32)
    c = cs.wrapper_cost("B 65,536", lambda: k.ppnet_fused_infer(big, big_ids, *stages))
    out["b65536"] = [c["device_ms"], c["host_us"], c["launches_per_call"]]
    for n in (3, 1):
        # layers 0 .. n - 1 with their gates; the final reads h_n through the
        # first column of layer n's weights
        cut = ([part[:n] for part in stages[:3]]
               + [(stages[0][n][0][:, :, :1].contiguous(), stages[3][1]), 2.0])
        ids = did.to(torch.int32)
        c = cs.wrapper_cost(f"the first {n} layers", lambda: k.ppnet_fused_infer(g, ids, *cut))
        out[f"layers{n}"] = [c["device_ms"], c["host_us"], c["launches_per_call"]]
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
