#!/usr/bin/env python3
"""Step 0 readings of STAR's eval kernel on one card: device ms (the host
kept out), host µs and launches per call, through ``chip_smoke.py``'s timer
(``wrapper_cost``), each call first held to its plain version (1e-5).

STAR at Ali-CCP, B = 4096 (F = 376, 3 domains, FCN [256, 128, 64, 32, 16,
8, 1] with a relu after every stage, aux [16] then 16 -> 1, the domain
norm's mean and rstd from the batch): with int64 ids (as the model passes
them) and int32 ids, at the wrapper's default tile and at ``block_rows`` 16,
32, 48 and 64 (a tile that a tree does not take, or that does not fit, is
logged as such). Then, with int64 ids at the default tile: B = 65,536 (the
partition by domain grows with B^2) and KuaiRand's ladder (F 800, 5
domains, FCN [128, 64, 32], aux [32]). Random weights and inputs from
``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/star_step0.py [--seed N]
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
        print("star_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    source = cs.EVAL_KERNELS["star"][1]
    cs.log("built", _build.build([source]))
    for line in _build.build_logs.get(source, "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    F, D = cs.N_SPARSE * 16 + cs.N_DENSE, cs.DOMAINS

    def inputs(B, Fi, Dn, fcn, aux):
        """emb and the kernel's arguments after the ids."""
        emb = torch.randn(B, Fi, generator=gen, device="cuda")
        var, mean = torch.var_mean(emb, dim=0, unbiased=False)
        g = 0.5 + torch.rand(Dn, Fi, generator=gen, device="cuda")
        b = 0.1 * torch.randn(Dn, Fi, generator=gen, device="cuda")
        return emb, (mean, torch.rsqrt(var + 1e-6), g, b,
                     cs.affines(gen, (Dn,), [Fi] + fcn + [1]), cs.affines(gen, (), [Fi] + aux),
                     cs.affines(gen, (), [aux[-1], 1])[0])

    def reading(label, emb, ids, star, **tile):
        want = k.star_fused_infer_ref(emb, ids, *star)
        try:
            got = k.star_fused_infer(emb, ids, *star, **tile)
        except (RuntimeError, ValueError) as e:  # a tile this tree does not take
            cs.log(f"    {label}: {str(e)[:160]}")
            return None
        err = (got - want).abs().max().item()
        cs.check(err <= cs.TOL, f"{label} disagrees with plain ({err})")
        c = cs.wrapper_cost(f"{label} (max_abs_err {err:.3e})",
                            lambda: k.star_fused_infer(emb, ids, *star, **tile))
        return [c["device_ms"], c["host_us"], c["launches_per_call"]]

    emb, ali = inputs(4096, F, D, [256, 128, 64, 32, 16, 8], [16])
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    out = {"card": card}
    for rep in range(2):
        for rows in (None, 16, 32, 48, 64):
            tile = {} if rows is None else {"block_rows": rows}  # None: the default
            for ids in (did, did.to(torch.int32)):
                label = f"{str(ids.dtype).split('.')[-1]} ids, block_rows={rows}"
                out[f"rep{rep} {label}"] = reading(f"rep {rep} {label}", emb, ids, ali, **tile)
    big, big_star = inputs(65_536, F, D, [256, 128, 64, 32, 16, 8], [16])
    big_ids = torch.randint(0, D, (65_536,), generator=gen, device="cuda")
    out["b65536"] = reading("B 65,536", big, big_ids, big_star)
    x, x_star = inputs(4096, 800, 5, [128, 64, 32], [32])
    x_ids = torch.randint(0, 5, (4096,), generator=gen, device="cuda")
    out["kuairand"] = reading("kuairand's ladder", x, x_ids, x_star)
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
