"""The traced run, reduced to what the per-layer readers read.

First ``steps`` steps with the benchmark's stage clock alone (CUDA events
at the trainer's marks): each step's device milliseconds per stage.  Then
``steps`` more under ``torch.profiler``, tracing the device's activity
only (recording every host operation too would double a launch-bound
step), with the clock's host times: every operation that ran on the
device (kernels, copies, sets), its name, start and length, and when the
host ended each stage.  ``busy_s`` is the length of the union of the
device's operations inside the profiled window, ``window_s`` the window's
length, from its start on the host to the end of its last step on the
device; both on the host's wall clock, which the profiler's device
timestamps are converted to.
"""
from __future__ import annotations

import collections
import dataclasses
import time

import torch
from torch.profiler import ProfilerActivity, profile

from .system import BenchClock, Program

DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")


def _activity(e) -> str:
    """A device event's kind: its activity type where this torch's events
    give one, else told by its name (the profiler names copies
    ``Memcpy ...`` and sets ``Memset ...``; the host's annotations that
    it mirrors on the device carry their own names)."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    if getattr(e, "is_user_annotation", lambda: False)():
        return "gpu_user_annotation"
    name = e.name()
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


@dataclasses.dataclass
class TraceContext:
    """What a per-layer reader gets."""

    steps: int
    ops: list            # (name, start_ns, dur_ns, activity) on the device
    stage_ms: list       # one dict a clocked step
    window_s: float
    busy_s: float
    marks: list          # (host ns, stage) of the profiled steps, in order
    window_ns: tuple     # (start, end) of the profiled steps, host ns
    m: dict              # the configuration's numbers
    traffic: object
    d: int
    peak: object

    @property
    def kernels(self) -> list:
        return [o for o in self.ops if o[3] == "kernel"]


def _union(intervals):
    """Sorted, merged (start, end) intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced_steps(prog: Program, steps: int, peak) -> TraceContext:
    clocked = []
    for _ in range(steps):
        clocked.append(BenchClock())
        prog.train_step(clock=clocked[-1])
    stage_ms = [c.stage_ms() for c in clocked]
    traced = []
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.time_ns()
        for _ in range(steps):
            traced.append(BenchClock())
            prog.train_step(clock=traced[-1])
        torch.cuda.synchronize()
        window = (t0, time.time_ns())
    ops = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            kind = _activity(e)
            if kind in DEVICE_ACTIVITIES:
                ops.append((e.name(), e.start_ns(), e.duration_ns(), kind))
    ops = [o for o in ops if o[1] < window[1] and o[1] + o[2] > window[0]]
    busy = _union((max(s, window[0]), min(s + n, window[1]))
                  for _, s, n, _ in ops)
    busy_s = sum(e - s for s, e in busy) * 1e-9
    marks = [(t, stage) for c in traced for stage, _, t in c.marks[1:]]
    return TraceContext(steps=steps, ops=ops, stage_ms=stage_ms,
                        window_s=(window[1] - window[0]) * 1e-9,
                        busy_s=busy_s, marks=marks, window_ns=window,
                        m=prog.m, traffic=prog.tr, d=prog.d, peak=peak)


def breakdown(ctx: TraceContext, top: int = 10) -> dict:
    """The device operations with the most time, and the device's idle
    time by the stage the host was in when each gap ended (the stage
    whose end it was working towards), each list at most ``top`` long."""
    by_name = collections.Counter()
    for name, _, dur, _ in ctx.ops:
        by_name[name[:160]] += dur * 1e-9
    busy = _union((max(s, ctx.window_ns[0]), min(s + n, ctx.window_ns[1]))
                  for _, s, n, _ in ctx.ops)
    edges = [ctx.window_ns[0]] + [x for iv in busy for x in iv] + [
        ctx.window_ns[1]]
    idle = collections.Counter()
    for s, e in zip(edges[0::2], edges[1::2]):
        if e <= s:
            continue
        stage = next((st for t, st in ctx.marks if t >= e), "end of window")
        idle[stage] += (e - s) * 1e-9
    return {"device_ops": [[k, v] for k, v in by_name.most_common(top)],
            "idle_gaps": [[k, v] for k, v in idle.most_common(top)]}
