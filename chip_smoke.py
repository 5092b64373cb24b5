#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's serving path on one card and check its kernels.

Run from the repository root on a machine with an NVIDIA Hopper card and
the CUDA toolkit:

    python3 chip_smoke.py [--seed N]

Phases; each asserts, and any failure exits non-zero:

1. Card and build: the card's name and power limit (nvidia-smi), then every
   ``scenario_wise_rec_tpu_torch/csrc/*.cu`` built with nvcc (one process per
   source, all started together), with the compiler's register report.
2. Kernel vs plain on the card: ``mmoe_fused_infer`` against
   ``mmoe_fused_infer_ref`` at (a) the Ali-CCP shape, B = 4096, (b) ragged
   B = 4095 and B = 1, (c) a narrow configuration, (d) domain ids -1, D and
   D+5; max |error| <= 1e-5 (f32 FMA order differs from cuBLAS). Times with
   CUDA events (warm-up, median of repeats) and the bound of the work.
3. Main path: MMOE at Ali-CCP width (23 sparse x 16, 8 dense, 3 domains,
   experts [256,128,64,32,16,8], tower [16]) with 467,000 ids per feature
   (a packed [10.74M, 16] f32 table) built on the card from ``--seed``;
   ``CTRTrainer(fused_inference=True).evaluate_multi_domain_loss`` and
   ``.predict`` over 8*4096+123 synthetic rows in batches of 4096. Every
   launch counter is set to 0 just before and read just after; the fused
   kernel must have launched once per batch. Predictions are held against
   the op-by-op path (``fused_inference=False``) and a narrow model against
   the CPU's plain path.
4. The card line, one ``{"kernels": [...]}`` line, and last the line
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import copy
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# Published peaks (dense, no sparsity) by card: f32 outside the tensor cores
# and memory bandwidth, from NVIDIA's data sheets, at full power.
PEAKS = {  # name fragment -> (f32 FLOP/s, bytes/s)
    "H100 PCIe": (51e12, 2.0e12),
    "H100 NVL": (60e12, 3.9e12),
    "H200": (67e12, 4.8e12),
    "H100": (67e12, 3.35e12),  # SXM
}
VOCAB, N_SPARSE, N_DENSE, DOMAINS, BATCH = 467_000, 23, 8, 3, 4096
EXPERT_DIMS, TOWER_DIMS = [256, 128, 64, 32, 16, 8], [16]
TOL = 1e-5


def check(cond, what):
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def peaks(name):
    for frag, p in PEAKS.items():
        if frag in name:
            return frag, p
    log(f"note: no published peaks for {name!r}; using the H100 SXM's")
    return "H100", PEAKS["H100"]


def time_ms(fn, reps=5, inner=20, warmup=3):
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls, from CUDA events around each run."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        runs.append(a.elapsed_time(b) / inner)
    return statistics.median(runs)


def random_stages(gen, F, E, D, expert_dims, tower_dims):
    """Weights scaled like torch's Linear init (std ~ 1/sqrt(in))."""
    def n(*shape, scale=1.0):
        return torch.randn(*shape, generator=gen, device="cuda") * scale

    ex, w = [], F
    for o in expert_dims:
        ex.append((n(E, w, o, scale=w ** -0.5), n(E, o, scale=0.1)))
        w = o
    gate = (n(D, F, E, scale=F ** -0.5), n(D, E))
    tw, h = [], w
    for o in tower_dims:
        tw.append((n(D, h, o, scale=h ** -0.5), n(D, o, scale=0.1)))
        h = o
    return ex, gate, tw, (n(D, h, 1, scale=h ** -0.5), n(D, 1))


def work(emb, did, ex, gate, tw, out):
    """(FLOPs, bytes) the function needs on these inputs: 2 per multiply-add,
    each row's own-domain gate and tower; each input read once, the output
    written once."""
    B = emb.shape[0]
    macs = sum(w.shape[0] * w.shape[1] * w.shape[2] for w, _ in ex)  # E * in * out
    macs += gate[0].shape[1] * gate[0].shape[2]
    macs += sum(w.shape[1] * w.shape[2] for w, _ in tw) + out[0].shape[1]
    tensors = [emb, did] + [t for s in ex for t in s] + list(gate) \
        + [t for s in tw for t in s] + list(out)
    nbytes = sum(t.numel() * t.element_size() for t in tensors) + B * 4
    return 2.0 * B * macs, float(nbytes)


def phase_kernels(gen, peak):
    from scenario_wise_rec_tpu_torch.ops.kernels.mmoe_infer import (
        mmoe_fused_infer, mmoe_fused_infer_ref)

    F = N_SPARSE * 16 + N_DENSE
    ali = random_stages(gen, F, DOMAINS, DOMAINS, EXPERT_DIMS, TOWER_DIMS)
    narrow = random_stages(gen, 42, 2, 2, [8], [4])

    def ids(B, D, lo=0, hi=None):
        return torch.randint(lo, D if hi is None else hi, (B,), generator=gen,
                             device="cuda")

    cases = {
        "a_alicpp_b4096": (torch.randn(4096, F, generator=gen, device="cuda"),
                           ids(4096, DOMAINS), ali),
        "b_ragged_b4095": (torch.randn(4095, F, generator=gen, device="cuda"),
                           ids(4095, DOMAINS), ali),
        "b_ragged_b1": (torch.randn(1, F, generator=gen, device="cuda"),
                        ids(1, DOMAINS), ali),
        "c_narrow_b1000": (torch.randn(1000, 42, generator=gen, device="cuda"),
                           ids(1000, 2), narrow),
    }
    oob = torch.tensor([-1, DOMAINS, DOMAINS + 5, 0, 1, 2], device="cuda")
    cases["d_domain_oob_b4096"] = (
        cases["a_alicpp_b4096"][0], oob[ids(4096, len(oob))], ali)
    max_err = 0.0
    for name, (emb, did, st) in cases.items():
        got = mmoe_fused_infer(emb, did, *st)
        torch.cuda.synchronize()
        want = mmoe_fused_infer_ref(emb, did, *st)
        check(got.shape == want.shape and bool(torch.isfinite(got).all()),
              f"{name}: bad output")
        err = (got - want).abs().max().item()
        log(f"  {name}: max_abs_err {err:.3e}")
        check(err <= TOL, f"{name}: kernel disagrees with plain ({err} > {TOL})")
        max_err = max(max_err, err)
    emb, did, st = cases["d_domain_oob_b4096"]
    clipped = mmoe_fused_infer(emb, did.clamp(0, DOMAINS - 1), *st)
    check(torch.equal(mmoe_fused_infer(emb, did, *st), clipped),
          "out-of-range domain ids are not clipped")

    emb, did, st = cases["a_alicpp_b4096"]
    for rows in (8, 16, 24, 32, 48):
        check((mmoe_fused_infer(emb, did, *st, block_rows=rows)
               - mmoe_fused_infer_ref(emb, did, *st)).abs().max().item() <= TOL,
              f"block_rows={rows} disagrees")
        log(f"  block_rows={rows}: "
            f"{time_ms(lambda: mmoe_fused_infer(emb, did, *st, block_rows=rows)):.4f} ms")
    kernel_ms = time_ms(lambda: mmoe_fused_infer(emb, did, *st))
    plain_ms = time_ms(lambda: mmoe_fused_infer_ref(emb, did, *st))
    flops, nbytes = work(emb, did, *st)
    t_ops, t_bytes = flops / peak[0] * 1e3, nbytes / peak[1] * 1e3
    log(f"  a_alicpp_b4096: kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"{flops / 1e9:.3f} GFLOP, {nbytes / 1e6:.2f} MB, bound {max(t_ops, t_bytes):.4f} ms "
        f"({'operations' if t_ops >= t_bytes else 'bytes'}), "
        f"{flops / kernel_ms / 1e9:.2f} TFLOP/s achieved")
    return {"name": "mmoe_fused_infer", "route": "cuda",
            "source": "scenario_wise_rec_tpu_torch/csrc/mmoe_infer.cu",
            "replaces": "scenario_wise_rec_tpu/ops/pallas/mmoe_infer.py:34",
            "max_abs_err": max_err, "ms": kernel_ms, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def synthetic_eval_set(seed, n):
    r = np.random.default_rng(seed)
    x = {f"s{i}": r.integers(0, VOCAB, n).astype(np.int64) for i in range(N_SPARSE)}
    x.update({f"d{i}": r.normal(size=n).astype(np.float32) for i in range(N_DENSE)})
    x["domain_indicator"] = r.integers(0, DOMAINS, n).astype(np.int64)
    y = (r.random(n) < 0.3).astype(np.float32)
    for d in range(DOMAINS):
        m = x["domain_indicator"] == d
        check(0 < y[m].sum() < m.sum(), f"domain {d} lacks a class")
    return x, y


def perturb_running_stats(model, gen):
    """Random BatchNorm running stats, so the eval folding does real work."""
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith(".mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=gen, device=buf.device))
            elif name.endswith(".var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=gen, device=buf.device))


def phase_main_path(seed, card):
    from scenario_wise_rec_tpu_torch.core import DenseFeature, SparseFeature
    from scenario_wise_rec_tpu_torch.data import BatchIterable, ColumnarDataset
    from scenario_wise_rec_tpu_torch.models import MMOE
    from scenario_wise_rec_tpu_torch.ops.kernels.mmoe_infer import mmoe_fused_infer
    from scenario_wise_rec_tpu_torch.train import CTRTrainer

    # a narrow model on the card against the same model on the CPU
    small_feats = [DenseFeature("d0")] + [SparseFeature(f"s{i}", 100, embed_dim=8)
                                          for i in range(3)]
    cpu_gen = torch.Generator(device="cpu").manual_seed(seed)
    small = MMOE(small_feats, 2, n_expert=2, expert_params={"dims": [16, 8]},
                 tower_params={"dims": [4]}, device="cpu", generator=cpu_gen)
    perturb_running_stats(small, cpu_gen)
    r = np.random.default_rng(seed)
    sx = {f"s{i}": r.integers(0, 100, 300) for i in range(3)}
    sx["d0"] = r.normal(size=300).astype(np.float32)
    sx["domain_indicator"] = r.integers(0, 2, 300)
    sl = BatchIterable(ColumnarDataset(sx, None), 128)
    want = np.asarray(CTRTrainer(small, device="cpu", fused_inference=True).predict(small, sl))
    small_gpu = copy.deepcopy(small)
    got = np.asarray(CTRTrainer(small_gpu, fused_inference=True).predict(small_gpu, sl))
    err = float(np.abs(got - want).max())
    log(f"  narrow model, card vs CPU: max_abs_err {err:.3e}")
    check(got.shape == (300,) and err <= TOL, "card disagrees with the CPU")

    t0 = time.perf_counter()
    feats = ([DenseFeature(f"d{i}") for i in range(N_DENSE)]
             + [SparseFeature(f"s{i}", vocab_size=VOCAB, embed_dim=16)
                for i in range(N_SPARSE)])
    gen = torch.Generator(device="cuda").manual_seed(seed)
    model = MMOE(feats, DOMAINS, n_expert=DOMAINS,
                 expert_params={"dims": EXPERT_DIMS},
                 tower_params={"dims": TOWER_DIMS}, device="cuda", generator=gen)
    perturb_running_stats(model, gen)
    torch.cuda.synchronize()
    check(tuple(model.embedding.packed.shape) == (N_SPARSE * VOCAB, 16), "table shape")
    log(f"  model built on the card in {time.perf_counter() - t0:.2f} s: packed table "
        f"{tuple(model.embedding.packed.shape)}, "
        f"{model.embedding.packed.numel() * 4 / 1e6:.1f} MB")
    n = 8 * BATCH + 123
    x, y = synthetic_eval_set(seed, n)
    loader = BatchIterable(ColumnarDataset(x, y), batch_size=BATCH)
    n_batches = len(loader)
    fused = CTRTrainer(model, fused_inference=True)
    plain = CTRTrainer(model, fused_inference=False)

    mmoe_fused_infer.launches = 0
    t0 = time.perf_counter()
    f_ll, f_auc, f_tll, f_tauc = fused.evaluate_multi_domain_loss(model, loader, DOMAINS)
    t1 = time.perf_counter()
    p_fused = np.asarray(fused.predict(model, loader))
    t2 = time.perf_counter()
    launches = mmoe_fused_infer.launches
    log(f"  fused path: {launches} kernel launches over {2 * n_batches} batches")
    check(launches == 2 * n_batches, "the main path did not launch the kernel once per batch")

    t3 = time.perf_counter()
    o_ll, o_auc, o_tll, o_tauc = plain.evaluate_multi_domain_loss(model, loader, DOMAINS)
    t4 = time.perf_counter()
    p_plain = np.asarray(plain.predict(model, loader))
    t5 = time.perf_counter()
    check(mmoe_fused_infer.launches == launches, "the op-by-op path launched the kernel")

    check(p_fused.shape == p_plain.shape == (n,), "prediction shape")
    check(bool(np.isfinite(p_fused).all()) and 0 < p_fused.min() and p_fused.max() < 1,
          "predictions not finite probabilities")
    err = float(np.abs(p_fused - p_plain).max())
    auc_gap = max(abs(a - b) for a, b in zip(f_auc + [f_tauc], o_auc + [o_tauc]))
    ll_gap = max(abs(a - b) for a, b in zip(f_ll + [f_tll], o_ll + [o_tll]))
    log(f"  fused vs op-by-op: max_abs_err {err:.3e}, auc gap {auc_gap:.3e}, "
        f"logloss gap {ll_gap:.3e}")
    log(f"  per-domain auc {[round(a, 6) for a in f_auc]}, total auc {f_tauc:.6f}, "
        f"total logloss {f_tll:.6f}")
    check(err <= TOL, f"fused and op-by-op predictions differ by {err}")
    check(auc_gap <= 1e-4, f"AUC differs by {auc_gap}")
    log(f"  eval examples/s on {card}: fused predict {n / (t2 - t1):,.0f}, "
        f"op-by-op predict {n / (t5 - t4):,.0f}; evaluate_multi_domain_loss "
        f"fused {n / (t1 - t0):,.0f}, op-by-op {n / (t4 - t3):,.0f}")
    profile_predict(fused, model, loader)
    return launches


def profile_predict(trainer, model, loader):
    """Device time by kernel over one ``predict`` pass, under torch.profiler
    (which adds host overhead, so the busy share is a lower bound)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.predict(model, loader)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    dev = lambda e: getattr(e, "self_device_time_total",
                            getattr(e, "self_cuda_time_total", 0)) / 1e3
    events = [e for e in prof.key_averages() if dev(e) > 0]
    busy_ms = sum(dev(e) for e in events)
    if not events:
        log("  profile: the profiler saw no device time (not measured)")
        return
    top = sorted(events, key=dev, reverse=True)[:8]
    log(f"  profile of one fused predict pass ({len(loader)} batches): wall "
        f"{wall_ms:.2f} ms, device busy {busy_ms:.3f} ms "
        f"({100 * busy_ms / wall_ms:.1f}%)")
    for e in top:
        log(f"    {dev(e):8.3f} ms  x{e.count:<4d} {e.key[:90]}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2

    from scenario_wise_rec_tpu_torch.ops.kernels import _build

    t_start = time.perf_counter()
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    log(f"[1] card: {card} | torch {torch.__version__} CUDA {torch.version.cuda} | {kind}")
    seconds = _build.build()
    for name, s in seconds.items():
        log(f"  built {name} in {s:.2f} s")
        for line in _build.build_logs.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"    {line.strip()}")
    peak_name, peak = peaks(kind)
    log(f"  bounds from the published {peak_name} peaks: "
        f"{peak[0] / 1e12:g} TFLOP/s f32, {peak[1] / 1e12:g} TB/s")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    log("[2] kernels vs plain versions on the card")
    entry = phase_kernels(gen, peak)

    log("[3] main path: MMOE serving at Ali-CCP width, 467k ids per feature")
    entry["launches"] = phase_main_path(args.seed, card)
    log(f"[4] done in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
