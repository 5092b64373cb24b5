#!/usr/bin/env python3
"""Step 0 readings of HAMUR's segment kernel and MMOE's eval kernel on one
card: device ms (the host kept out), host µs and launches per call, through
``chip_smoke.py``'s timer (``wrapper_cost``).

HamurLarge at Ali-CCP, B = 4096 (F = 376, blocks [256,128,64,64,32,16 | 8],
hyper [64], k = 65, 3 domains): each of its three segment launches alone,
then the three together at the default tile and at ``block_rows`` 16, 32
and 48, each twice. MMOE: ``chip_smoke.py``'s whole ``phase_kernels``
(cases, sweep and Step 0). Random weights and inputs from ``--seed``.

Run from the root of a checkout (or of an unpacked older commit, to compare
two trees on one card in one call):

    python3 scripts/hamur_step0.py [--seed N]
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
        print("hamur_step0: no CUDA device", file=sys.stderr)
        return 2
    from scenario_wise_rec_tpu_torch.ops import kernels as k
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    card, kind = cs.card_line(), torch.cuda.get_device_name(0)
    cs.log(f"card: {card} | {kind} | torch {torch.__version__} CUDA {torch.version.cuda} "
           f"| tree {os.getcwd()}")
    cs.log("built", _build.build(["mmoe_infer", "hamur_infer"]))
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                cs.log(f"  {name}: {line.strip()}")
    _, peak = cs.peaks(kind)
    mmoe = cs.phase_kernels(torch.Generator(device="cuda").manual_seed(args.seed), peak)
    gen = torch.Generator(device="cuda").manual_seed(args.seed + 1)
    D, F = cs.DOMAINS, cs.N_SPARSE * 16 + cs.N_DENSE
    emb = torch.randn(4096, F, generator=gen, device="cuda")
    did = torch.randint(0, D, (4096,), generator=gen, device="cuda")
    large = cs.hamur_args(gen, F, D, [[256, 128, 64, 64, 32, 16], [8], []], [64], 65)
    segs = cs.hamur_segment_inputs(emb, did, *large)
    out = {"card": card, "mmoe_device_ms": mmoe["ms"],
           "mmoe_sweep_device_ms": mmoe["block_rows_sweep_device_ms"]}
    for rep in range(2):
        for i, (x, st, kw) in enumerate(segs):
            c = cs.wrapper_cost(f"rep {rep} segment {i + 1}",
                                lambda: k.hamur_segment(x, st, **kw))
            out[f"rep{rep}_segment{i + 1}_device_ms"] = c["device_ms"]
        for rows in (None, 16, 32, 48):
            tile = {} if rows is None else {"block_rows": rows}  # None: the wrapper's default
            c = cs.wrapper_cost(f"rep {rep} three segments, block_rows={rows}",
                                lambda: [k.hamur_segment(x, st, **tile, **kw)
                                         for x, st, kw in segs])
            out[f"rep{rep}_three_rows{rows}"] = [c["device_ms"], c["host_us"],
                                                 c["launches_per_call"]]
    cs.log(card)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
