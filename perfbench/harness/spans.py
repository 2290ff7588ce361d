"""The program's own spans (``repro_torch.timing``), as the per-layer
readers read them.

A traced run records the spans of its four steps in the trainer (each
is handed the benchmark's stage clock); ``recorded`` takes them from the
program, or gives None where it keeps none (a program without the
recorder).  The clocked steps' spans (host start before the profiled
window) give device milliseconds a step; the profiled steps' spans lay
the device's idle gaps on the host's work: an idle gap counts towards a
layer for as long as the host was inside one of that layer's spans,
those opened directly under the ``step`` span, so that no instant counts
twice.
"""
from __future__ import annotations

from repro_torch import timing

from .trace import _union

# the direct children of ``step`` that make up a layer's host work
GRAD = ("forward", "backward")
WIRE = ("stats", "fit", "encode", "collective", "unpack", "checksum",
        "decode", "requant", "compress")


def recorded() -> list | None:
    """The program's recorded spans, or None where it records none."""
    get = getattr(timing, "recorded", None)
    spans = get() if get is not None else None
    return spans or None


def device_ms(ctx, name: str) -> float | None:
    """Device milliseconds a step of every span ``name`` of the last
    ``ctx.steps`` steps recorded before the profiled window."""
    spans = recorded()
    if spans is None:
        return None
    before = [s for s in spans if s.t0 < ctx.window_ns[0]]
    steps = sorted({s.step for s in before})[-ctx.steps:]
    if not steps:
        return None
    return sum(s.ms() for s in before if s.step in steps and s.name == name
               and s.kind == "span") / ctx.steps


def _intersect(a: list, b: list) -> int:
    """The length of the intersection of two sorted, merged interval
    lists."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_ms(ctx, names: tuple) -> float | None:
    """Milliseconds a step in which no device operation ran while the
    host was inside a span of ``names`` opened directly under ``step``,
    over the profiled steps' spans."""
    spans = recorded()
    if spans is None:
        return None
    w0, w1 = ctx.window_ns
    inside = [s for s in spans if s.t0 >= w0 and s.t1 <= w1]
    steps = {s.id for s in inside if s.name == "step"}
    if not steps:
        return None
    host = _union((s.t0, s.t1) for s in inside
                  if s.parent in steps and s.name in names)
    busy = _union((max(s, w0), min(s + n, w1)) for _, s, n, _ in ctx.ops)
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    idle = [[s, e] for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    return _intersect(idle, host) * 1e-6 / ctx.steps
