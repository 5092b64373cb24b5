#!/usr/bin/env python3
"""Step 0 readings of SAR-Net's eval kernel on one card: device ms (the host
kept out), host µs and launches per call, through ``chip_smoke.py``'s timer
(``wrapper_cost``), each call first held to its plain version (1e-5; a
reading that misses it is logged, timed all the same, and fails the run).

SAR-Net at Ali-CCP, B = 4096 (the default loader: F = 23 x 16 = 368, 3
domains, 8 shared and 2 own experts of width 16, gate 368 -> 10, final MLP
[32, 32] and head), int64 ids, twice: at the wrapper's default tile and at
``block_rows`` 16, 32, 48 and 64 (a tile that a tree does not take, or that
does not fit, is logged as such), and with int32 ids. Then, at the default
tile: B = 65,536 and KuaiRand's widths, the weights of
``configs.build_model("kuairand", "sarnet", ...)`` folded for eval (its 796
sparse columns, 5 domains). Last, the error split at B = 65,536: the kernel
and the plain version in f32 each against the plain version in f64. Random
weights and inputs from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/sarnet_step0.py [--seed N]
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
        print("sarnet_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch import configs
    from scenario_wise_rec_tpu_torch.core import SparseFeature
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    source = cs.EVAL_KERNELS["sarnet"][1]
    cs.log("built", _build.build([source]))
    for line in _build.build_logs.get(source, "").splitlines():
        if "registers" in line or "spill" in line:
            cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    F, D = cs.N_SPARSE * 16, cs.DOMAINS
    failed = []

    def reading(label, fn, ref):
        want = ref()
        try:
            got = fn()
        except (RuntimeError, ValueError) as e:  # a tile this tree does not take
            cs.log(f"    {label}: {str(e)[:160]}")
            return None
        err = cs.kernel_gap(got, want, None)
        held = bool(torch.isfinite(got).all()) and err <= cs.TOL
        if not held:  # timed all the same (an older tree's reading), and the run fails
            failed.append(f"{label}: {err}")
        c = cs.wrapper_cost(f"{label} (max_abs_err {err:.3e}"
                            f"{'' if held else ', DISAGREES with plain'})", fn)
        return [c["device_ms"], c["host_us"], c["launches_per_call"]]

    def sar_reading(label, inputs, weights, **tile):
        return reading(label, lambda: k.sarnet_fused_infer(*inputs, *weights, **tile),
                       lambda: k.sarnet_fused_infer_ref(*inputs, *weights))

    def weights(Fi, Dn):
        return (2 * torch.rand(Dn, Fi, generator=gen, device="cuda") - 1,
                torch.rand(Dn, Fi, generator=gen, device="cuda"),
                cs.affines(gen, (8,), [Fi, 16])[0], cs.affines(gen, (Dn, 2), [Fi, 16])[0],
                cs.affines(gen, (), [Fi, 10])[0], cs.affines(gen, (), [16, 32, 32]),
                cs.affines(gen, (), [32, 1])[0])

    def inputs(B, Fi, Dn):
        return (torch.randn(B, Fi, generator=gen, device="cuda"),
                torch.randint(0, Dn, (B,), generator=gen, device="cuda"))

    ali, ali_in = weights(F, D), inputs(4096, F, D)
    out = {"card": card}
    for rep in range(2):
        for tile_rows in (None, 16, 32, 48, 64):
            tile = {} if tile_rows is None else {"block_rows": tile_rows}  # None: the default
            label = f"SAR-Net block_rows={tile_rows}"
            out[f"rep{rep} {label}"] = sar_reading(f"rep {rep} {label}", ali_in, ali, **tile)
        out[f"rep{rep} int32"] = sar_reading(f"rep {rep} SAR-Net int32 ids, default tile",
                                             (ali_in[0], ali_in[1].to(torch.int32)), ali)
    big = inputs(65_536, F, D)
    out["b65536"] = sar_reading("SAR-Net B 65,536", big, ali)
    # KuaiRand's SAR-Net, as its ladder builds it: the sparse features only
    sparse = [SparseFeature(f"s{i}", vocab_size=100, embed_dim=16) for i in range(49)]
    sparse.append(SparseFeature("s49", vocab_size=100, embed_dim=12))  # 796 sparse columns
    model = configs.build_model("kuairand", "sarnet", {"sparse_feas": sparse, "domain_num": 5},
                                device="cuda", generator=gen)
    model.eval()
    with torch.no_grad():
        kr = model.fold_eval()
    Fk = kr[0].shape[1]
    out["kuairand"] = sar_reading(f"SAR-Net at KuaiRand's widths (F {Fk})", inputs(4096, Fk, 5),
                                  kr)
    # the error split at B 65,536: each f32 result against the plain version in f64
    with torch.no_grad():
        f64 = k.sarnet_fused_infer_ref(big[0].double(), big[1],
                                       *[t.double() for t in cs.flat(ali[:2])],
                                       *[tuple(t.double() for t in s) for s in ali[2:5]],
                                       [tuple(t.double() for t in s) for s in ali[5]],
                                       tuple(t.double() for t in ali[6]))
        kern = k.sarnet_fused_infer(*big, *ali).double()
        plain = k.sarnet_fused_infer_ref(*big, *ali).double()
    out["error_split_b65536"] = {
        "kernel_vs_f64": (kern - f64).abs().max().item(),
        "plain_f32_vs_f64": (plain - f64).abs().max().item(),
        "kernel_vs_plain_f32": (kern - plain).abs().max().item()}
    cs.log(f"  error split at B 65,536: {out['error_split_b65536']}")
    cs.log(card)
    print(json.dumps(out))
    for f in failed:
        cs.log(f"sarnet_step0: disagrees with plain beyond {cs.TOL}: {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
