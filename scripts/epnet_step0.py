#!/usr/bin/env python3
"""Step 0 readings of EPNet's eval kernel on one card: device ms (the host
kept out), host µs and launches per call, through ``chip_smoke.py``'s timer
(``wrapper_cost``), each call first held to its plain version (1e-5).

EPNet at Ali-CCP, B = 4096 (the scenario loader: S 16, A = 22 x 16 + 8 =
360, gate 376 -> 360 -> 360, head 360 -> 1, gemma 2), twice: at the
wrapper's default tile and at ``block_rows`` 16, 32, 48 and 64 (a tile that
a tree does not take, or that does not fit, is logged as such). Then, at
the default tile: B = 65,536 and KuaiRand's widths (S 16, A 800). Beside
them, AdaSparse's Step 0 at Ali-CCP, B = 4096, in the Fusion form at the
default tile, twice (the kernel EPNet's runs on; its rows near the hard
threshold counted and held to 0.01 % of the batch, as ``chip_smoke.py``
holds them). Random weights and inputs from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call: cd there and run this file of the newer
tree):

    python3 scripts/epnet_step0.py [--seed N]
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
        print("epnet_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card = cs.card_line()
    cs.log(f"card: {card} | {torch.cuda.get_device_name(0)} | torch {torch.__version__} "
           f"CUDA {torch.version.cuda} | tree {os.getcwd()}")
    sources = sorted({cs.EVAL_KERNELS[m][1] for m in ("epnet", "adasparse")})
    cs.log("built", _build.build(sources))
    for source in sources:
        for line in _build.build_logs.get(source, "").splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  {source}: {line.strip()}")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    S = 16

    def rows(B, width):
        return torch.randn(B, width, generator=gen, device="cuda")

    def epnet(A):
        return (*cs.affines(gen, (), [S + A, A]), *cs.affines(gen, (), [A, A]),
                cs.affines(gen, (), [A, 1])[0])

    def reading(label, fn, ref, near=None):
        want = ref()
        try:
            got = fn()
        except (RuntimeError, ValueError) as e:  # a tile this tree does not take
            cs.log(f"    {label}: {str(e)[:160]}")
            return None
        err = cs.kernel_gap(got, want, near)
        excused = 0 if near is None else int(near.sum())
        cs.check(bool(torch.isfinite(got).all()) and err <= cs.TOL
                 and excused <= cs.THRESHOLD_ROWS * len(got),
                 f"{label} disagrees with plain ({err}, {excused} rows excused)")
        c = cs.wrapper_cost(f"{label} (max_abs_err {err:.3e}, {excused} rows excused)", fn)
        return [c["device_ms"], c["host_us"], c["launches_per_call"]]

    def epnet_reading(label, sce, agn, stages, **tile):
        return reading(label, lambda: k.epnet_fused_infer(sce, agn, *stages, **tile),
                       lambda: k.epnet_fused_infer_ref(sce, agn, *stages))

    A = (cs.N_SPARSE - 1) * 16 + cs.N_DENSE
    ali = epnet(A)
    sce, agn = rows(4096, S), rows(4096, A)
    # AdaSparse at Ali-CCP: A 352, layers [256, ..., 8], alpha 1.37 folded
    Aa = (cs.N_SPARSE - 1) * 16
    pw = [0.6 * 1.37 * (S + h) ** -0.5 * torch.randn(S + h, h, generator=gen, device="cuda")
          for h in [Aa] + cs.EXPERT_DIMS]
    ada = (pw, cs.affines(gen, (), [S + Aa] + cs.EXPERT_DIMS),
           cs.affines(gen, (), [cs.EXPERT_DIMS[-1], 1])[0])
    ada_in = (rows(4096, S), rows(4096, Aa))
    kw = dict(form="Fusion", epsilon=1e-2, beta=2.0)
    near = k.adasparse_threshold_margin(*ada_in, *ada, **kw) <= cs.THRESHOLD_GAP
    out = {"card": card}
    for rep in range(2):
        for tile_rows in (None, 16, 32, 48, 64):
            tile = {} if tile_rows is None else {"block_rows": tile_rows}  # None: the default
            label = f"EPNet block_rows={tile_rows}"
            out[f"rep{rep} {label}"] = epnet_reading(f"rep {rep} {label}", sce, agn, ali, **tile)
        out[f"rep{rep} AdaSparse Fusion"] = reading(
            f"rep {rep} AdaSparse Fusion, default tile",
            lambda: k.adasparse_fused_infer(*ada_in, *ada, **kw),
            lambda: k.adasparse_fused_infer_ref(*ada_in, *ada, **kw), near)
    out["b65536"] = epnet_reading("EPNet B 65,536", rows(65_536, S), rows(65_536, A), ali)
    out["kuairand"] = epnet_reading("EPNet at KuaiRand's widths", rows(4096, S),
                                    rows(4096, 800), epnet(800))
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
