#!/usr/bin/env python3
"""Step 0 readings of AdaSparse's eval kernel on one card: device ms (the
host kept out), host µs and launches per call, through ``chip_smoke.py``'s
timer (``wrapper_cost``), each call first held to its plain version (1e-5
on every row that the threshold rule does not excuse; the excused rows are
counted and held to 0.01 % of the batch, as ``chip_smoke.py`` holds them).

AdaSparse at Ali-CCP, B = 4096 (S 16, A 352, layers [256, 128, 64, 32, 16,
8], a pruner before the layers and after each, alpha = 1.37 folded into the
pruners) in each form at the wrapper's default tile, and in the Fusion form
at ``block_rows`` 16, 32 and 48 (the tiles both the first design and the
redesign take; one a tree does not take is logged as such). Then, in the
Fusion form at the default tile, where the time goes: B = 65,536, the stack
cut to pruner 0 alone (no layers: the head on [sce ‖ agn], pruner 0's 36 %
of a row's multiply-adds kept), and the layers 8 wide (every pruner and layer
but pruner 0 nearly gone, their 12 steps kept). Last, EPNet's kernel at
Ali-CCP (S 16, A 360, gate 376 -> 360 -> 360), which runs on AdaSparse's
kernel. Random weights and inputs from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/adasparse_step0.py [--seed N]
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
        print("adasparse_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    sources = sorted({cs.EVAL_KERNELS[m][1] for m in ("adasparse", "epnet")})
    cs.log("built", _build.build(sources))
    for source in sources:
        for line in _build.build_logs.get(source, "").splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    S, A = 16, (cs.N_SPARSE - 1) * 16

    def weights(dims, alpha=1.37):
        pw = [0.6 * alpha * (S + h) ** -0.5 * torch.randn(S + h, h, generator=gen, device="cuda")
              for h in [A] + dims]
        return (pw, cs.affines(gen, (), [S + A] + dims),
                cs.affines(gen, (), [dims[-1] if dims else S + A, 1])[0])

    def reading(label, sce, agn, stages, form="Fusion", **tile):
        kw = dict(form=form, epsilon=1e-2, beta=2.0)
        want = k.adasparse_fused_infer_ref(sce, agn, *stages, **kw)
        try:
            got = k.adasparse_fused_infer(sce, agn, *stages, **kw, **tile)
        except (RuntimeError, ValueError) as e:  # a tile this tree does not take
            cs.log(f"    {label}: {str(e)[:160]}")
            return None
        near = k.adasparse_threshold_margin(sce, agn, *stages, **kw) <= cs.THRESHOLD_GAP
        err = cs.kernel_gap(got, want, near)
        cs.check(err <= cs.TOL and int(near.sum()) <= cs.THRESHOLD_ROWS * len(got),
                 f"{label} disagrees with plain ({err}, {int(near.sum())} rows excused)")
        c = cs.wrapper_cost(f"{label} (max_abs_err {err:.3e}, {int(near.sum())} rows excused)",
                            lambda: k.adasparse_fused_infer(sce, agn, *stages, **kw, **tile))
        return [c["device_ms"], c["host_us"], c["launches_per_call"]]

    ali = weights(cs.EXPERT_DIMS)
    sce = torch.randn(4096, S, generator=gen, device="cuda")
    agn = torch.randn(4096, A, generator=gen, device="cuda")
    out = {"card": card}
    for rep in range(2):
        for form in ("Binarization", "Scaling", "Fusion"):
            label = f"rep {rep} {form}, default tile"
            out[f"rep{rep} {form}"] = reading(label, sce, agn, ali, form)
        for rows in (16, 32, 48):
            label = f"rep {rep} Fusion, block_rows={rows}"
            out[f"rep{rep} block_rows={rows}"] = reading(label, sce, agn, ali, block_rows=rows)
    big = (torch.randn(65_536, S, generator=gen, device="cuda"),
           torch.randn(65_536, A, generator=gen, device="cuda"))
    out["b65536"] = reading("B 65,536", *big, ali)
    out["pruner0"] = reading("pruner 0 alone (no layers)", sce, agn, weights([]))
    out["layers8"] = reading("the layers 8 wide", sce, agn, weights([8] * 6))
    Ae = A + cs.N_DENSE
    sce_e = torch.randn(4096, S, generator=gen, device="cuda")
    agn_e = torch.randn(4096, Ae, generator=gen, device="cuda")
    epnet = (*cs.affines(gen, (), [S + Ae, Ae]), *cs.affines(gen, (), [Ae, Ae]),
             cs.affines(gen, (), [Ae, 1])[0])
    err = (k.epnet_fused_infer(sce_e, agn_e, *epnet)
           - k.epnet_fused_infer_ref(sce_e, agn_e, *epnet)).abs().max().item()
    cs.check(err <= cs.TOL, f"epnet_fused_infer disagrees with plain ({err})")
    c = cs.wrapper_cost(f"EPNet, default tile (max_abs_err {err:.3e})",
                        lambda: k.epnet_fused_infer(sce_e, agn_e, *epnet))
    out["epnet"] = [c["device_ms"], c["host_us"], c["launches_per_call"]]
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
