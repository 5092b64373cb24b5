#!/usr/bin/env python3
"""Step 0 readings of M2M's eval kernel on one card: device ms (the host
kept out), host µs and launches per call, through ``chip_smoke.py``'s timer
(``wrapper_cost``), each call first held to its plain version (1e-5; a
reading that misses it is logged, timed all the same, and fails the run).

M2M after its transformer at Ali-CCP, B = 4096 (the scenario loader: F =
22 x 16 + 8 + the 16-wide scenario embedding = 376, Fd 16, 4 experts of E =
16, one-layer hyper-MLPs, vw 16 -> 1024, output MLP [64, 32]), twice: at the
wrapper's default tile and at ``block_rows`` 8, 16, 24, 32, 48 and 64 (a
tile that a tree does not take, or that does not fit, is logged as such).
Then, at the default tile: B = 65,536 and KuaiRand's widths, the weights of
``configs.build_model("kuairand", "m2m", ...)`` folded for eval (its 796
sparse columns and the scenario feature's 16: F 812). Beside them, SAR-Net's
Step 0 at Ali-CCP, B = 4096, at the default tile, twice (``scripts/
sarnet_step0.py`` reads SAR-Net's kernel at every tile and shape). Random
weights and inputs from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/m2m_step0.py [--seed N]
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
        print("m2m_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch import configs
    from scenario_wise_rec_tpu_torch.core import SparseFeature
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    sources = sorted({cs.EVAL_KERNELS[m][1] for m in ("m2m", "sarnet")})
    cs.log("built", _build.build(sources))
    for source in sources:
        for line in _build.build_logs.get(source, "").splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    F, E = cs.N_SPARSE * 16 + cs.N_DENSE, 16

    def rows(B, width):
        return torch.randn(B, width, generator=gen, device="cuda")

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

    def m2m_reading(label, t_out, dom, weights, **tile):
        return reading(label, lambda: k.m2m_fused_infer(t_out, dom, *weights, E=E, **tile),
                       lambda: k.m2m_fused_infer_ref(t_out, dom, *weights, E=E))

    hyper = lambda i, o: cs.affines(gen, (), [i, o])
    ali = (cs.affines(gen, (4,), [F, E]), hyper(16, E), hyper(16, E), hyper(E, 4 * E * E),
           hyper(E, 2 * E), hyper(E, E * E), hyper(E, E),
           torch.randn(2 * E, 1, generator=gen, device="cuda"), cs.affines(gen, (), [E, 64, 32]),
           cs.affines(gen, (), [32, 1])[0])
    t_out, dom = rows(4096, F), rows(4096, 16)
    # SAR-Net at Ali-CCP, as chip_smoke.py's case: the default loader, Fs =
    # 23 x 16; 8 shared and 2 specific experts of width 16, gate Fs -> 10,
    # final [32, 32] and head
    Fs, D = cs.N_SPARSE * 16, cs.DOMAINS
    sar = (2 * torch.rand(D, Fs, generator=gen, device="cuda") - 1,
           torch.rand(D, Fs, generator=gen, device="cuda"),
           cs.affines(gen, (8,), [Fs, 16])[0], cs.affines(gen, (D, 2), [Fs, 16])[0],
           cs.affines(gen, (), [Fs, 10])[0], cs.affines(gen, (), [16, 32, 32]),
           cs.affines(gen, (), [32, 1])[0])
    sar_in = (rows(4096, Fs), torch.randint(0, D, (4096,), generator=gen, device="cuda"))
    out = {"card": card}
    for rep in range(2):
        for tile_rows in (None, 8, 16, 24, 32, 48, 64):
            tile = {} if tile_rows is None else {"block_rows": tile_rows}  # None: the default
            label = f"M2M block_rows={tile_rows}"
            out[f"rep{rep} {label}"] = m2m_reading(f"rep {rep} {label}", t_out, dom, ali, **tile)
        out[f"rep{rep} SAR-Net"] = reading(
            f"rep {rep} SAR-Net, default tile", lambda: k.sarnet_fused_infer(*sar_in, *sar),
            lambda: k.sarnet_fused_infer_ref(*sar_in, *sar))
    out["b65536"] = m2m_reading("M2M B 65,536", rows(65_536, F), rows(65_536, 16), ali)
    # KuaiRand's M2M, as its ladder builds it: the scenario feature in both
    # the features and the domain feature
    sce = [SparseFeature("domain_indicator", vocab_size=5, embed_dim=16)]
    sparse = [SparseFeature(f"s{i}", vocab_size=100, embed_dim=16) for i in range(49)]
    sparse.append(SparseFeature("s49", vocab_size=100, embed_dim=12))  # 796 sparse columns
    model = configs.build_model("kuairand", "m2m", {"sparse_feas": sparse, "scenario_feas": sce,
                                                     "domain_num": 5},
                                device="cuda", generator=gen)
    model.eval()
    Fk = model.input_dim
    with torch.no_grad():
        kr = model.fold_eval()
    out["kuairand"] = m2m_reading(f"M2M at KuaiRand's widths (F {Fk})", rows(4096, Fk),
                                  rows(4096, 16), kr)
    cs.log(card)
    print(json.dumps(out))
    for f in failed:
        cs.log(f"m2m_step0: disagrees with plain beyond {cs.TOL}: {f}")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
