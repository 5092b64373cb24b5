#!/usr/bin/env python3
"""Fused against op-by-op serving on one card, per model: the measurement
behind ``FUSED_INFERENCE_WINS`` (``scenario_wise_rec_tpu_torch/ops/kernels/
__init__.py``), the set that ``CTRTrainer(fused_inference="auto")`` consults.

Each of the 13 model classes with a fused eval path is built at Ali-CCP
width with 467k ids per feature from the loader ``chip_smoke.py`` serves it
from (``build_ali_model``: ``configs.build_model("ali_ccp", name, ...)``,
running statistics perturbed, random weights from ``--seed``). HamurSmall
has no Ali-CCP entry in the ladders, so it is the MovieLens ladder's
(``build_model("movielens", "hamur", ...)``: fcn [256, 128], hyper [64],
k 35) on Ali-CCP's features.

Two trainers share each model, ``fused_inference=True`` (F) and ``False``
(O). After one untimed ``predict`` pass of each, ``predict`` runs over
8 * 4096 + 123 rows in batches of 4096 in turns F, O, O, F, three times (6
runs a path), each run timed by the host clock between two
``torch.cuda.synchronize()`` calls. That is one sitting; ``--sittings``
of them are taken, each model built anew.

The verdict pools every sitting on record for this card: the committed
record (``fused_auto_pairs_h100.json`` beside this script, earlier runs of
this measurement) and this run's. In a sitting, fused leads if its median
examples/s is above op by op's. A class is in the set iff fused led in so
many of the n sittings that a fair coin would do as well less than 5 times
in 100 (one-sided sign test): where the card cannot tell the two apart, op
by op (the reference path, no kernel) wins. Serving is host-bound, and the
host clock moves by a third from one machine to the next, so one sitting,
or one run within it, decides nothing; a sitting's two paths share its
machine, and the test asks only which one led there.

Prints a line per model and sitting, this run's sittings as one JSON line,
the card's name and power limit, the verdict per class and the set. With
``--out`` it writes the pooled record (the committed one and this run's
sittings) there. ``--sittings 0`` measures nothing and needs no card: it
prints the verdict of the record alone, which is how the committed set is
reproduced.

    python3 scripts/fused_auto_pairs.py [--seed N] [--sittings 6] [--out PATH]

This run's sittings are numbered in the record as one more call than its
last.
"""

import argparse
import json
import math
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
RECORD = Path(__file__).resolve().with_name("fused_auto_pairs_h100.json")
# registry name (chip_smoke's) -> class name
MODELS = {"mmoe": "MMOE", "sharedbottom": "SharedBottom", "ple": "PLE", "star": "Star",
          "sarnet": "Sarnet", "epnet": "EPNet", "ppnet": "PPNet", "adasparse": "AdaSparse",
          "hamur": "HamurLarge", "hamur_small": "HamurSmall", "adaptdhm": "AdaptDHM",
          "m2m": "M2M", "m3oe": "M3oE"}
ROUNDS = 3  # of the turns F, O, O, F
LEVEL = 0.05  # of the one-sided sign test over sittings


def sign_p(k, n):
    """P(at least ``k`` heads in ``n`` tosses of a fair coin)."""
    return sum(math.comb(n, i) for i in range(k, n + 1)) / 2 ** n


def verdict(sittings):
    """Per class: the number of sittings where fused's median led, of how
    many, the sign test's p, whether the class is in the set, and per path
    the median of the sittings' medians and the range of every run."""
    out = {}
    for cls in MODELS.values():
        rows = [s["models"][cls] for s in sittings if cls in s["models"]]
        k = sum(r["fused"]["median"] > r["op_by_op"]["median"] for r in rows)
        p = sign_p(k, len(rows))
        out[cls] = {"leads": k, "sittings": len(rows), "p": p, "in": bool(rows) and p < LEVEL}
        for path in ("fused", "op_by_op"):
            out[cls][path] = (statistics.median(r[path]["median"] for r in rows),
                              min(r[path]["min"] for r in rows),
                              max(r[path]["max"] for r in rows)) if rows else None
    return out


def load_record(path):
    """The record at ``path``: ``{"card", "rows", "batch", "sittings": [...]}``,
    each sitting ``{"call", "sitting", "models": {class: {"fused": {"median",
    "min", "max"[, "runs"]}, "op_by_op": {...}}}}``."""
    return json.loads(Path(path).read_text())


def dump_record(record):
    """The record as JSON text, a line per sitting."""
    head = {k: v for k, v in record.items() if k != "sittings"}
    return (json.dumps(head)[:-1] + ', "sittings": [\n'
            + ",\n".join(json.dumps(s) for s in record["sittings"]) + "\n]}\n")


def build(cs, seed, name):
    """``name`` at Ali-CCP width on the card, as chip_smoke's serving phase
    builds it; HamurSmall from the MovieLens ladder on Ali-CCP's features."""
    import torch

    if name != "hamur_small":
        return cs.build_ali_model(seed, perturb=True, name=name)
    from scenario_wise_rec_tpu_torch.configs import build_model

    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = build_model("movielens", "hamur", cs.ali_data(), device="cuda", generator=gen)
    cs.perturb_running_stats(model, gen)
    cs.randomize_adapters(model, gen)
    return model


def timed_predict(cs, trainer, model, loader, n_rows):
    import numpy as np
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p = trainer.predict(model, loader)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    cs.check(len(p) == n_rows and np.isfinite(p).all(), "predictions")
    return n_rows / dt


def pair(cs, seed, name, loader, n_rows):
    """Examples/s of the fused and the op-by-op predict pass of one model,
    6 runs each in turns F, O, O, F."""
    import torch
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    model = build(cs, seed, name)
    cs.check(type(model).__name__ == MODELS[name], f"{name} built a {type(model).__name__}")
    trainers = {"fused": CTRTrainer(model, fused_inference=True),
                "op_by_op": CTRTrainer(model, fused_inference=False)}
    cs.check(trainers["fused"]._fused_inference, f"{name}: no fused eval path")
    kernel = cs.EVAL_KERNELS[name if name != "hamur_small" else "hamur"][0]
    cs.reset_counts()
    for t in trainers.values():  # untimed: kernels loaded, cuBLAS warmed
        t.predict(model, loader)
    cs.check(cs.read_counts()[kernel] > 0, f"{name}: the fused pass launched no {kernel}")
    rates = {"fused": [], "op_by_op": []}
    for _ in range(ROUNDS):
        for path in ("fused", "op_by_op", "op_by_op", "fused"):
            rates[path].append(timed_predict(cs, trainers[path], model, loader, n_rows))
    del trainers, model
    torch.cuda.empty_cache()
    return rates


def measure(seed, n_sittings, call):
    """``n_sittings`` sittings on the card: ``(card line, rows, batch,
    sittings)`` in the record's form."""
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    if not torch.cuda.is_available():
        raise SystemExit("fused_auto_pairs: no CUDA device")
    card = cs.card_line()
    _build.build()
    n_rows = 8 * cs.BATCH + 123
    x, y = cs.synthetic_eval_set(seed, n_rows)
    loader = BatchIterable(ColumnarDataset(x, y), batch_size=cs.BATCH)
    sittings = []
    for sitting in range(1, n_sittings + 1):
        models = {}
        for name, cls in MODELS.items():
            rates = pair(cs, seed, name, loader, n_rows)
            models[cls] = {path: {"median": statistics.median(v), "min": min(v),
                                  "max": max(v), "runs": v} for path, v in rates.items()}
            f, o = models[cls]["fused"], models[cls]["op_by_op"]
            print(f"sitting {sitting} {cls:>12}: fused median {f['median']:,.0f} ex/s "
                  f"[{f['min']:,.0f} .. {f['max']:,.0f}], op by op median "
                  f"{o['median']:,.0f} [{o['min']:,.0f} .. {o['max']:,.0f}]: fused "
                  f"{'leads' if f['median'] > o['median'] else 'trails'}", flush=True)
        sittings.append({"call": call, "sitting": sitting, "models": models})
    return card, n_rows, cs.BATCH, sittings


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--sittings", type=int, default=6,
                    help="sittings to measure on the card (0: the record's verdict alone)")
    ap.add_argument("--out", help="write the pooled record here")
    args = ap.parse_args()
    record = load_record(RECORD)
    if args.sittings:
        call = max(s["call"] for s in record["sittings"]) + 1
        card, n_rows, batch, new = measure(args.seed, args.sittings, call)
        print(json.dumps({"card": card, "seed": args.seed, "sittings": new}))
        if (record["card"], record["rows"], record["batch"]) != (card, n_rows, batch):
            raise SystemExit(f"fused_auto_pairs: the record is of {record['card']} at "
                             f"{record['rows']} rows in batches of {record['batch']}, not "
                             f"{card} at {n_rows} in {batch}: not pooled")
        record = {"card": card, "rows": n_rows, "batch": batch,
                  "sittings": record["sittings"] + new}
    if args.out:
        Path(args.out).write_text(dump_record(record))
    calls = sorted({s["call"] for s in record["sittings"]})
    print(f"{record['card']}: {len(record['sittings'])} sittings (calls "
          f"{', '.join(map(str, calls))})")
    table = verdict(record["sittings"])
    for cls, v in table.items():
        (fm, flo, fhi), (om, olo, ohi) = v["fused"], v["op_by_op"]
        print(f"{cls:>12}: fused led in {v['leads']} of {v['sittings']} sittings, sign test "
              f"p {v['p']:.4f}: {'in' if v['in'] else 'out'}; medians' median, every run's "
              f"range (ex/s): fused {fm:,.0f} [{flo:,.0f} .. {fhi:,.0f}], op by op "
              f"{om:,.0f} [{olo:,.0f} .. {ohi:,.0f}]")
    wins = sorted(c for c, v in table.items() if v["in"])
    print("FUSED_INFERENCE_WINS = frozenset({" + ", ".join(f'"{c}"' for c in wins) + "})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
