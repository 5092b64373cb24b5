"""The port's profiling module (``scenario_wise_rec_tpu_torch/train/profiling.py``)
on the CPU: ``StepTimer`` against the JAX package's on the same recorded
durations; ``trace`` of a narrow MMOE ``CTRTrainer`` step writing a trace
file that loads and holds an ``annotate`` range; ``attribute``'s groups
against its busy total on a CPU profile and on hand-built records;
``profile_records`` on planted lost records; the mesh's collectives in
their ranges; and no JAX in the module or in ``chip_smoke.py``.
"""

import json
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import _torch_port_parallel_worker as W  # noqa: E402
from scenario_wise_rec_tpu.train import profiling as jprof  # noqa: E402
from scenario_wise_rec_tpu_torch.train import profiling as prof  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

DURATIONS = {
    "none": [],
    "one": [0.0123456],
    "window_overflow": list(np.random.default_rng(0).uniform(1e-4, 5e-2, 317)),
}


@pytest.mark.parametrize("name", sorted(DURATIONS))
def test_step_timer_summary_matches_jax(name):
    """The same durations pushed into both ``times`` deques (the window of
    200 dropping the oldest): equal summaries, throughput and means."""
    ours, theirs = prof.StepTimer(batch_size=4096), jprof.StepTimer(batch_size=4096)
    for d in DURATIONS[name]:
        ours.times.append(d)
        theirs.times.append(d)
    assert ours.summary() == theirs.summary()
    assert ours.examples_per_s == theirs.examples_per_s
    assert ours.mean_step_s == theirs.mean_step_s


def test_step_timer_times_its_block():
    timer = prof.StepTimer(batch_size=8, window=2)
    for _ in range(3):
        with timer:
            pass
    assert len(timer.times) == 2 and all(t >= 0 for t in timer.times)
    assert timer.summary()["steps"] == 2


def _train_step():
    """A narrow MMOE trainer (the parallel worker's model) and one step's
    arguments, one step taken already."""
    t = W.trainer(W.port_model())
    batch = t._device_batch(*W.batch(3))
    t._train_step(*batch)
    return t, batch


def test_trace_writes_a_loadable_file_with_the_annotate_range(tmp_path):
    t, batch = _train_step()
    with prof.trace(str(tmp_path)) as p:
        with prof.annotate("one narrow mmoe step"):
            t._train_step(*batch)
    assert p is not None
    files = prof.trace_files(str(tmp_path))
    assert len(files) == 1 and os.path.getsize(files[0]) > 0
    with open(files[0]) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "one narrow mmoe step" in names
    # the warm-up step's records are dropped; the pad is in the trace, not
    # in the readers
    assert prof.PAD in names
    recs, _ = prof.timed_records(p)
    assert recs and not any(r.name == prof.PAD for r in recs)


def test_attribute_groups_sum_to_busy_on_a_cpu_profile():
    """A host-only profile of two CPU train steps: every op's own time in
    one group, the groups summing to the busy total, which is the
    profile's own self-time total; the op tree tells the forward GEMMs
    from the backward ones, and the dense Adam's ops lie in its range."""
    t, batch = _train_step()
    with prof.trace(cuda=False) as p:
        for _ in range(2):
            t._train_step(*batch)
    att = prof.attribute(p, 2)
    groups = att["ms_per_step"]
    assert sum(groups.values()) * 2 == pytest.approx(att["busy_ms"], rel=1e-12)
    from torch.autograd import DeviceType
    self_total = sum(e.self_cpu_time_total for e in p.key_averages()
                     if e.device_type == DeviceType.CPU
                     and not getattr(e, "is_user_annotation", False)) / 1e3
    assert att["busy_ms"] == pytest.approx(self_total, rel=1e-6)
    assert groups["forward GEMMs"] > 0 and groups["backward GEMMs"] > 0
    assert groups["dense Adam"] > 0 and groups["GEMMs, pass not known"] == 0
    assert 0 < att["busy_share"] <= 1 and att["lost"] == "" and att["steps"] == 2
    scopes = prof.record_scopes(p)
    assert scopes["aten::mm"] in ("backward", "mixed")
    assert "optimizer" in set(scopes.values())


def _rec(name, start, ns, scope):
    return prof.Record(name, start, start + ns, ns, scope)


def test_attribute_on_hand_built_records():
    """Each record in the first group it matches; a replay's records (no
    scope) take the eager step's scope by name; the groups sum to the
    busy time, the wall is the records' span."""
    recs = [_rec("void dense_adam_kernel<float>(...)", 0, 1_400_000, None),
            _rec("void tile_starts_kernel(...)", 1_400_000, 10_000, None),
            _rec("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", 2_000_000, 300_000,
                 "other"),
            _rec("sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize128x128x8", 2_400_000, 200_000,
                 "backward"),
            _rec("ampere_sgemm_128x64_tn", 2_700_000, 100_000, None),
            _rec("ampere_sgemm_64x64_nt", 2_800_000, 50_000, None),
            _rec("void at::native::multi_tensor_apply_kernel<...>", 3_000_000, 250_000, None),
            _rec("void at::native::vectorized_elementwise_kernel<4, AddFunctor>", 3_300_000,
                 40_000, "optimizer"),
            _rec("void at::native::indexSelectLargeIndex<float>", 3_400_000, 30_000, "other"),
            _rec("Memcpy DtoD (Device -> Device)", 3_500_000, 20_000, None),
            _rec("void at::native::reduce_kernel<512, 1>", 3_600_000, 60_000, "backward"),
            _rec("some_kernel_of_no_known_kind", 3_700_000, 5_000, None)]
    scopes = {"ampere_sgemm_128x64_tn": "other", "ampere_sgemm_64x64_nt": "mixed"}
    att = prof.attribute(recs, 2, scopes=scopes)
    ms = {k: round(v * 2, 6) for k, v in att["ms_per_step"].items()}
    assert ms == {"embedding update": 1.41, "forward GEMMs": 0.4, "backward GEMMs": 0.2,
                  "GEMMs, pass not known": 0.05, "dense Adam": 0.29,
                  "gathers and index ops": 0.03, "copies and memsets": 0.02,
                  "elementwise and reductions": 0.06, "the rest": 0.005}
    assert sum(att["ms_per_step"].values()) * 2 == pytest.approx(att["busy_ms"], rel=1e-12)
    assert att["busy_ms"] == pytest.approx(2.465, rel=1e-12)
    assert att["wall_ms"] == pytest.approx(3.705, rel=1e-12)
    assert att["records"] == len(recs) and att["lost"] == ""
    # caller's groups: a catch-all collects what no group names
    own = prof.attribute(recs, 1, groups=(("updates", r"adam", None),))
    assert own["ms_per_step"]["updates"] == pytest.approx(1.4)
    assert own["ms_per_step"]["the rest"] == pytest.approx(1.065)


class _Event:
    """A stand-in for the profiler's raw records (``_KinetoEvent``)."""

    def __init__(self, name, start, corr, device=False, annotation=False, end=None):
        from torch.autograd import DeviceType

        self._name, self._start, self._corr = name, start, corr
        self._end = start + 1 if end is None else end
        self._device = DeviceType.CUDA if device else DeviceType.CPU
        self._annotation = annotation

    def name(self):
        return self._name

    def start_ns(self):
        return self._start

    def end_ns(self):
        return self._end

    def device_type(self):
        return self._device

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation


def _profile(events):
    return SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))


def _graph_and_launches(short, bare):
    """Three graph launches of 3 kernels each and two kernel launches, with
    ``short`` records taken from the last graph launch and the second
    kernel launch's record left out if ``bare``; a pad range and its
    kernel after them."""
    ev, at = [], 0
    for corr in (10, 11, 12):
        ev.append(_Event("cudaGraphLaunch", at, corr))
        n = 3 - (short if corr == 12 else 0)
        ev += [_Event(f"kernel_{i}", at + 1 + i, corr, device=True) for i in range(n)]
        at += 10
    for corr in (20, 21):
        ev.append(_Event("cudaLaunchKernel", at, corr))
        if not (bare and corr == 21):
            ev.append(_Event("dense_adam_kernel", at + 1, corr, device=True))
        at += 10
    ev.append(_Event(prof.PAD, at, 0, annotation=True, end=at + 100))
    ev.append(_Event("cudaLaunchKernel", at + 5, 30))
    ev.append(_Event(prof.PAD_KERNEL, at + 6, 30, device=True))
    return _profile(ev)


@pytest.mark.parametrize("short,bare", [(0, False), (1, False), (0, True), (2, True)])
def test_profile_records_reports_planted_losses(short, bare):
    dev, graph, losses = prof.profile_records(_graph_and_launches(short, bare))
    assert len(dev) == 10 - short + (not bare)  # the pad's kernel left out
    assert graph == [3, 3, 3 - short]
    assert (f"{short} records short in graph launches" in losses) == bool(short)
    assert ("1 launches without a record, at [4] of 5" in losses) == bare
    assert bool(losses) == bool(short or bare)


def test_collectives_appear_in_their_ranges(tmp_path):
    """A one-rank gloo group in a process of its own: ``all_reduce_``,
    ``all_gather_rows`` and ``broadcast_`` each under its range, beside the
    profiler's own ``c10d::`` op records."""
    code = f"""
import torch, torch.distributed as dist
from scenario_wise_rec_tpu_torch.parallel import mesh
from scenario_wise_rec_tpu_torch.train import profiling
dist.init_process_group("gloo", init_method="file://{tmp_path}/rendezvous", rank=0,
                        world_size=1)
group = dist.new_group([0])
t = torch.arange(6.0)
with profiling.trace(cuda=False) as p:
    mesh.all_reduce_(t, group)
    rows = mesh.all_gather_rows(t, group)
    mesh.broadcast_(t, group)
assert torch.equal(rows, torch.arange(6.0))
names = [e.name() for e in p.profiler.kineto_results.events()]
for n in ("mesh.all_reduce_", "mesh.all_gather_rows", "mesh.broadcast_"):
    assert names.count(n) == 1, (n, names)
assert sum(n.startswith("c10d::") for n in names) >= 3, names
dist.destroy_process_group()
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120,
                         env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr


@pytest.mark.parametrize("module", ["scenario_wise_rec_tpu_torch.train.profiling",
                                    "chip_smoke"])
def test_imports_no_jax(module):
    """With ``jax`` and the JAX package made unimportable, the module
    imports, and neither is loaded after it."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'scenario_wise_rec_tpu'):\n"
            "    sys.modules[m] = None\n"
            f"import {module}\n"
            "assert not any(k.split('.')[0] in ('jax', 'jaxlib') and v is not None\n"
            "               for k, v in sys.modules.items())\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, timeout=120, env=dict(os.environ, PYTHONPATH=REPO))
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stdout + out.stderr
