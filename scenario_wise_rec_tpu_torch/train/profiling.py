"""Tracing and profiling (the JAX package's ``train/profiling.py``), on
``torch.profiler``.

- :class:`StepTimer`: a window of step wall times with an examples/s
  summary (``time.perf_counter`` and a ``deque`` append a step).
- :func:`trace`: a ``torch.profiler`` capture with margins at both ends,
  written as a Chrome / TensorBoard trace; it yields the profiler, which
  the readers below take.
- :func:`annotate`: a named range that appears in the trace.
- The readers: :func:`device_and_host` (a call's device ms apart from its
  host µs), :func:`device_events` (a profile's device rows),
  :func:`profile_records` (its raw device records and what it lost) and
  :func:`attribute` (a profile's device time split into named groups a
  step).

Launches are not counted here: the profiler has read 0-0.9 launches a call
for a one-launch kernel on the H100, and a CUDA graph's replays leave no
launch of their own. Each kernel wrapper counts its launches and captures
(``ops/kernels/*.py``), and a graphed trainer its replays
(``CTRTrainer.graph_replays``).

Imports no JAX.
"""

from __future__ import annotations

import bisect
import contextlib
import os
import re
import statistics
import time
from collections import deque
from typing import NamedTuple, Optional

import torch
from torch.profiler import (ProfilerActivity, profile, record_function, schedule,
                            tensorboard_trace_handler)


class StepTimer:
    """The wall times of the last ``window`` steps; ``summary()`` reports
    throughput. It times the host's block, as the JAX one does: a caller
    that wants the device's time syncs inside the block (for example
    ``torch.cuda.synchronize()`` or ``CTRTrainer.barrier()`` as its last
    line)."""

    def __init__(self, batch_size: int, window: int = 200):
        self.batch_size = batch_size
        self.times = deque(maxlen=window)
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    @property
    def mean_step_s(self) -> float:
        return sum(self.times) / max(len(self.times), 1)

    @property
    def examples_per_s(self) -> float:
        m = self.mean_step_s
        return self.batch_size / m if m else 0.0

    def summary(self) -> dict:
        return {
            "steps": len(self.times),
            "mean_step_ms": round(self.mean_step_s * 1e3, 3),
            "examples_per_s": round(self.examples_per_s, 1),
        }


PAD = "profiling: pad"  # trace's closing range
PAD_KERNEL = "spin_kernel"  # torch.cuda._sleep's kernel, the pad's


@contextlib.contextmanager
def trace(logdir: Optional[str] = None, cuda: Optional[bool] = None):
    """Profile the enclosed work with ``torch.profiler`` (the host always,
    the card with ``cuda``, by default when one is available) and yield the
    profiler; with ``logdir`` the trace is written there on exit, one
    ``<host>_<pid>.<ns>.pt.trace.json`` (Chrome trace format, which
    TensorBoard's profiler plugin and Perfetto open).

    Margins at both ends: a few launches (and on the card a sync) in the
    profiler's warm-up step, whose records are dropped, before the recorded
    step opens; and after the enclosed work, inside the recorded step, a
    range ``PAD`` (on the card 16 ``torch.cuda._sleep`` kernels of 500,000
    cycles and a sync) and a 5 ms pause, which every reader here leaves
    out. Without margins a profile on the H100 missed the records of its
    first few launches, more of them the more profiles the process had
    taken, and now and then those of its last work (the last graph
    launch's last kernels and the launches after it). No CUDA graph may be
    captured under the profile: a capture's launches leave no records."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + [ProfilerActivity.CUDA] * bool(cuda)
    ready = None if logdir is None else tensorboard_trace_handler(logdir)
    with profile(activities=activities, schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=ready) as prof:
        x = torch.zeros(1024, device="cuda" if cuda else "cpu")
        for _ in range(16):
            x.add_(1)
        if cuda:
            torch.cuda.synchronize()
        prof.step()
        yield prof
        with record_function(PAD):
            if cuda:
                for _ in range(16):
                    torch.cuda._sleep(500_000)
                torch.cuda.synchronize()
            time.sleep(0.005)


def trace_files(logdir: str) -> list:
    """The trace files :func:`trace` wrote into ``logdir``, oldest first."""
    names = sorted((os.path.getmtime(os.path.join(logdir, n)), n) for n in os.listdir(logdir)
                   if n.endswith(".pt.trace.json"))
    return [os.path.join(logdir, n) for _, n in names]


def annotate(name: str):
    """A named range around the enclosed host code, in every trace taken
    while it runs. It records on the host only: no launch, no sync, and
    nothing that a CUDA graph captures."""
    return record_function(name)


# -- readers -------------------------------------------------------------------

def device_and_host(fn, inner=50, reps=5, warmup=3):
    """``(device ms, host µs)`` per call of ``fn`` on the card, the host's
    issue cost kept out of the first. ``torch.cuda._sleep`` holds the
    stream before the start event long enough that the host has queued all
    ``inner`` calls before the card reaches them, so the events bracket
    device work only; the host's ``perf_counter`` over the same calls (the
    queue never drains while it runs) gives the issue cost. A run in which
    the card caught up with the host is repeated with a longer sleep; a
    ``fn`` that waits for the card itself (a sync inside) can never be held
    so, and gives ``(None, host µs)``. Keep a timed run under ~400 launches:
    a full launch queue makes the host wait for the card."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    torch.cuda.synchronize()
    # ~2 GHz: 4x the whole run's wall time, host and device together
    cycles = max(1_000_000, int(4 * (time.perf_counter() - t0) * 2e9))
    dev, host, misses = [], [], 0
    while misses < 3:
        s, a, b = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        s.record()
        tq = time.perf_counter()
        torch.cuda._sleep(cycles)
        a.record()
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        t1 = time.perf_counter()
        b.record()
        b.synchronize()
        if (t1 - tq) * 1e3 >= s.elapsed_time(a):  # the card reached the calls first
            cycles, misses = 2 * cycles, misses + 1
            continue
        dev.append(a.elapsed_time(b) / inner)
        host.append((t1 - t0) * 1e6 / inner)
        if len(dev) == reps:
            return statistics.median(dev), statistics.median(host)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(inner):
        fn()
    return None, (time.perf_counter() - t0) * 1e6 / inner


def device_ms(event):
    """A profiler event's own device time, ms."""
    return getattr(event, "self_device_time_total",
                   getattr(event, "self_cuda_time_total", 0)) / 1e3


def device_events(averages):
    """The device-side events (kernels, copies, memsets) of a profile's
    ``key_averages()``: an op's row, and a user annotation's such as
    ``Optimizer.step``, repeats the time of the kernels inside it; the
    pad of :func:`trace` is left out."""
    from torch.autograd import DeviceType

    return [e for e in averages if e.device_type != DeviceType.CPU and device_ms(e) > 0
            and not getattr(e, "is_user_annotation", False) and PAD_KERNEL not in e.key]


def _raw(prof):
    """A profile's raw records, the pad's ``(start, end)`` ranges and the
    device records but the pad's."""
    from torch.autograd import DeviceType

    raw = prof.profiler.kineto_results.events()
    pads = [(e.start_ns(), e.end_ns()) for e in raw if e.name() == PAD]
    dev = [e for e in raw if e.device_type() != DeviceType.CPU and not e.is_user_annotation()
           and PAD_KERNEL not in e.name()]
    return raw, pads, dev


def profile_records(prof):
    """The raw device records of a profile, the ``cudaGraphLaunch`` calls'
    record counts, and what the profile lost by its own bookkeeping: every
    replay of the one captured step runs the same nodes and every kernel
    launch one kernel, so a graph launch with fewer device records than the
    most any launch had, a kernel launch with none, or a device record whose
    launching call is missing, is a record the profiler dropped (no capture
    may run under the profile: a launch inside one has no record; the
    wrappers' counters do not come into this test). The pad of
    :func:`trace`, its kernels and the calls in its range, is left out.
    Returns ``(device records, graph launches' record counts, losses)``,
    ``losses`` an empty string for a whole profile."""
    from torch.autograd import DeviceType

    raw, pads, dev = _raw(prof)
    host = [e for e in raw if e.device_type() == DeviceType.CPU and e.correlation_id()
            and not any(a <= e.start_ns() <= b for a, b in pads)]
    per_call = {}
    for e in dev:
        per_call[e.correlation_id()] = per_call.get(e.correlation_id(), 0) + 1
    calls = {e.correlation_id() for e in host}
    graph = [per_call.get(e.correlation_id(), 0) for e in host if e.name() == "cudaGraphLaunch"]
    launches = [per_call.get(e.correlation_id(), 0)
                for e in sorted(host, key=lambda e: e.start_ns())
                if re.match(r"cu(da)?LaunchKernel|cudaGraphLaunch", e.name())]
    short = sum(max(graph) - n for n in graph) if graph else 0
    bare = [i for i, n in enumerate(launches) if n == 0]  # places in launch order
    orphans = sum(1 for e in dev if e.correlation_id() not in calls)
    losses = [f"{short} records short in graph launches (counts {sorted(set(graph))})"] * bool(
        short) + [f"{len(bare)} launches without a record, at " + (
            f"{bare}" if len(bare) <= 8 else f"{bare[:4]}...{bare[-4:]}")
        + f" of {len(launches)}"] * bool(bare) + [
        f"{orphans} device records without their launching call"] * bool(orphans)
    return dev, graph, "; ".join(losses)


# -- attribution ---------------------------------------------------------------

class Record(NamedTuple):
    """One timed record: ``ns`` is the time it counts (a device record's
    duration; a host op's own time, its nested ops' taken out), ``scope``
    where its launching host code ran: ``"backward"`` (inside the autograd
    engine's ``evaluate_function``), ``"optimizer"`` (inside an
    ``Optimizer.step`` range), ``"other"``, or None where no launching op
    is known (a kernel of a CUDA graph replay)."""
    name: str
    start_ns: int
    end_ns: int
    ns: int
    scope: Optional[str]


# the runtime calls that put work on the card
_LAUNCH = re.compile(r"^cu(da)?(LaunchKernel|LaunchCooperativeKernel|GraphLaunch|Memcpy|Memset)")
GEMM = (r"gemm|gemv|xmma|cutlass|splitKreduce"
        r"|^aten::(mm|addmm|bmm|baddbmm|addmv|mv|matmul|linear)$")
# The groups of :func:`attribute`: ``(label, name pattern, scope)``, the
# first that a record matches taking it; a label may stand on several lines
# (their times add up). The embedding update's kernels by the wrappers'
# kernel names (``csrc/sorted_adam.cu``, ``fused_adam.cu``,
# ``row_update.cu``); the dense Adam by its ``Optimizer.step`` range where
# the launching op is known, and inside a graph replay by its foreach
# kernels (``multi_tensor_apply``), which nothing else in a train step
# launches.
GROUPS = (
    ("embedding update", r"dense_adam_kernel|tile_starts_kernel|segsum_(rows|sorted)_kernel"
                         r"|scatter_(bulk|lanes)_kernel", None),
    ("forward GEMMs", GEMM, "other"),
    ("backward GEMMs", GEMM, "backward"),
    ("GEMMs, pass not known", GEMM, None),
    ("dense Adam", None, "optimizer"),
    ("dense Adam", r"multi_tensor_apply", None),
    ("gathers and index ops", r"index|gather|scatter|embedding|[Ss]ort|CatArray|unique|take"
                              r"|^aten::(cat|where|nonzero|masked_select)$", None),
    ("copies and memsets", r"Memcpy|Memset|copy_kernel|^aten::(copy_|fill_|zero_|clone)$", None),
    ("elementwise and reductions", r"elementwise|[Rr]educe|softmax|norm|[Ss]can|"
                                   r"distribution|bernoulli|dropout|^aten::", None),
    ("the rest", None, None),
)


def _intervals(events):
    """``{thread: (starts, ends)}``: each thread's ranges merged into
    disjoint sorted ones."""
    by = {}
    for e in sorted(events, key=lambda e: e.start_ns()):
        runs = by.setdefault(e.start_thread_id(), [])
        if runs and e.start_ns() <= runs[-1][1]:
            runs[-1][1] = max(runs[-1][1], e.end_ns())
        else:
            runs.append([e.start_ns(), e.end_ns()])
    return {t: ([a for a, _ in r], [b for _, b in r]) for t, r in by.items()}


def _inside(intervals, thread, t):
    starts, ends = intervals.get(thread, ((), ()))
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t <= ends[i]


def timed_records(prof):
    """A profile's records as :class:`Record` s, the pad left out: its
    device records (kernels, copies, memsets), each with the scope of its
    launching call; or, on a profile without any (the host only), every
    host op with its own time and scope. With the records, the profile's
    wall ns: from its first record (host or device, the user ranges aside)
    to its last."""
    from torch.autograd import DeviceType

    raw, pads, dev = _raw(prof)
    out_pad = lambda e: not any(a <= e.start_ns() <= b for a, b in pads)
    host = [e for e in raw if e.device_type() == DeviceType.CPU and out_pad(e)]
    ops = [e for e in host if not e.is_user_annotation()]
    backward = _intervals(e for e in ops
                          if e.name().startswith("autograd::engine::evaluate_function"))
    optimizer = _intervals(e for e in host if e.is_user_annotation()
                           and e.name().startswith("Optimizer.step"))

    def scope(thread, t):
        return ("backward" if _inside(backward, thread, t)
                else "optimizer" if _inside(optimizer, thread, t) else "other")

    spans = ops + dev
    wall = (max(e.end_ns() for e in spans) - min(e.start_ns() for e in spans)) if spans else 0
    if dev:
        launch = {e.correlation_id(): e for e in ops if _LAUNCH.match(e.name())}
        recs = []
        for e in dev:
            call = launch.get(e.correlation_id())
            where = (None if call is None or call.name() == "cudaGraphLaunch"
                     else scope(call.start_thread_id(), call.start_ns()))
            recs.append(Record(e.name(), e.start_ns(), e.end_ns(), e.end_ns() - e.start_ns(),
                               where))
        return recs, wall
    # the host only: each op's own time, its directly nested ops' taken out
    recs, stacks = [], {}
    for e in sorted(ops, key=lambda e: (e.start_ns(), -e.end_ns())):
        stack = stacks.setdefault(e.start_thread_id(), [])
        while stack and stack[-1][0].end_ns() <= e.start_ns():
            recs.append(stack.pop())
        if stack:
            stack[-1][1] -= e.end_ns() - e.start_ns()
        stack.append([e, e.end_ns() - e.start_ns()])
    for stack in stacks.values():
        recs += stack
    return [Record(e.name(), e.start_ns(), e.end_ns(), max(own, 0),
                   scope(e.start_thread_id(), e.start_ns())) for e, own in recs], wall


def record_scopes(prof) -> dict:
    """``{record name: scope}`` of a profile whose launching ops are known
    (an eager step's): the one scope each name was launched from, or
    ``"mixed"``. :func:`attribute` gives it to a graph replay's records,
    which have no launching op: a GEMM kernel seen only in the eager
    step's forward is then a forward GEMM in the replay too."""
    seen = {}
    for r in timed_records(prof)[0]:
        if r.scope is not None:
            seen.setdefault(r.name, set()).add(r.scope)
    return {k: v.pop() if len(v) == 1 else "mixed" for k, v in seen.items()}


def group_of(record: Record, groups=GROUPS, scopes: Optional[dict] = None) -> str:
    """The label of the first of ``groups`` that ``record`` matches (the
    rule of :func:`attribute`), or ``"the rest"``."""
    sc = record.scope if record.scope is not None else (scopes or {}).get(record.name)
    return next((label for label, pat, want in groups
                 if (pat is None or re.search(pat, record.name)) and (want is None or want == sc)),
                "the rest")


def attribute(prof, steps: int, groups=GROUPS, scopes: Optional[dict] = None) -> dict:
    """The device time of ``steps`` steps in a profile (or a list of
    :class:`Record` s), split into named groups.

    The rule: every record of :func:`timed_records` (the card's kernels,
    copies and memsets; on a profile of the host only, its ops' own times)
    joins the first of ``groups`` whose name pattern (``re.search``, None
    for any) matches its name and whose scope (None for any) equals its
    scope, or ``"the rest"``. A record's scope is where its launching op
    ran (:class:`Record`); inside a CUDA graph replay no op launched it, so
    it takes ``scopes[name]`` (:func:`record_scopes` of an eager profile of
    the same step), or stays unknown. So the groups partition the records
    and sum to the busy time.

    Returns ``{"steps", "ms_per_step": {label: ms a step}, "busy_ms" (the
    records' summed time), "wall_ms" (first record to last; a list of
    records: its span), "busy_share", "records", "lost"}``; ``lost`` is what
    :func:`profile_records` found the profile lost, empty for a whole one
    or a list."""
    if isinstance(prof, (list, tuple)):
        recs, lost = list(prof), ""
        wall = (max(r.end_ns for r in recs) - min(r.start_ns for r in recs)) if recs else 0
    else:
        recs, wall = timed_records(prof)
        lost = profile_records(prof)[2]
    per = {label: 0 for label, _, _ in groups}
    per.setdefault("the rest", 0)
    for r in recs:
        per[group_of(r, groups, scopes)] += r.ns
    busy = sum(r.ns for r in recs)
    return {"steps": steps,
            "ms_per_step": {k: v / 1e6 / steps for k, v in per.items()},
            "busy_ms": busy / 1e6, "wall_ms": wall / 1e6,
            "busy_share": busy / wall if wall else None, "records": len(recs), "lost": lost}
