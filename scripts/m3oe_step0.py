#!/usr/bin/env python3
"""Step 0 readings of M3oE's eval kernel on one card: device ms (the host
kept out), host µs and launches per call, through ``chip_smoke.py``'s timer
(``wrapper_cost``), each call first held to its plain version (1e-5).

M3oE at Ali-CCP, B = 4096 (F = 376, star [512, 256], 4 experts and 3 domain
experts 256 -> 64, tower 64): int64 ids (as ``chip_smoke.py`` and the
trainer pass them) and int32 ids at the wrapper's default tile and at
``block_rows`` 16, 32, 48 and 64 (a tile that does not fit is logged as
such). Then, with int64 ids at the default tile, where the time goes:
B = 65,536 (the partition by domain grows with B^2), the 7 experts and the
tower cut to width 8 (their products 8 wide, 21 % of a row's multiply-adds
nearly gone, their 8 steps kept), and the star slot cut to width 8 (the star
slot and the star MLP, 60 % of a row's multiply-adds, nearly gone). Random
weights and inputs from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/m3oe_step0.py [--seed N]
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
        print("m3oe_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    source = cs.EVAL_KERNELS["m3oe"][1]
    cs.log("built", _build.build([source]))
    for line in _build.build_logs.get(source, "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    F, D = cs.N_SPARSE * 16 + cs.N_DENSE, cs.DOMAINS

    def weights(s1, h):
        l1 = cs.ln_layers(gen, (D,), [h, h])[0]
        return (cs.affines(gen, (D,), [F, s1])[0], cs.ln_layers(gen, (), [F, 256]),
                cs.ln_layers(gen, (), [s1, 256]), cs.affines(gen, (D,), [256, 4])[0],
                cs.ln_layers(gen, (4,), [256, h]), cs.ln_layers(gen, (D,), [256, h]),
                (*l1, *cs.affines(gen, (D,), [h, 1])[0]),
                torch.sigmoid(torch.randn(1, generator=gen, device="cuda")),
                torch.sigmoid(torch.randn(1, generator=gen, device="cuda")))

    def reading(label, emb, ids, stages, **tile):
        want = k.m3oe_fused_infer_ref(emb, ids, *stages)
        try:
            got = k.m3oe_fused_infer(emb, ids, *stages, **tile)
        except (RuntimeError, ValueError) as e:  # a tile this tree does not take
            cs.log(f"    {label}: {str(e)[:160]}")
            return None
        err = (got - want).abs().max().item()
        cs.check(err <= cs.TOL, f"{label} disagrees with plain ({err})")
        c = cs.wrapper_cost(f"{label} (max_abs_err {err:.3e})",
                            lambda: k.m3oe_fused_infer(emb, ids, *stages, **tile))
        return [c["device_ms"], c["host_us"], c["launches_per_call"]]

    ali = weights(512, 64)
    emb = torch.randn(4096, F, generator=gen, device="cuda")
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    out = {"card": card}
    for rep in range(2):
        for rows in (None, 16, 32, 48, 64):
            for ids in (did, did.to(torch.int32)):
                tile = {} if rows is None else {"block_rows": rows}  # None: the default
                label = f"{str(ids.dtype).split('.')[-1]} ids, block_rows={rows}"
                out[f"rep{rep} {label}"] = reading(f"rep {rep} {label}", emb, ids, ali, **tile)
    big = torch.randn(65_536, F, generator=gen, device="cuda")
    big_ids = torch.randint(0, D, (65_536,), generator=gen, device="cuda")
    out["b65536"] = reading("B 65,536", big, big_ids, ali)
    out["experts8"] = reading("the experts and the tower 8 wide", emb, did, weights(512, 8))
    out["star8"] = reading("the star slot 8 wide", emb, did, weights(8, 64))
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
