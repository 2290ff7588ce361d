"""Spans, counters and stage marks of a train step: one recorder.

A **span** is a named interval of the host's work: its id, the id of the
span it opened inside (``parent``), the step it belongs to, the worker
it ran for (where there is one), its host start and end in nanoseconds
of ``time.time_ns()`` (the clock that ``torch.profiler`` converts the
device's timestamps to, so spans and a device trace share one time
axis), and a dict of counters that ``count(name, n)`` adds to while the
span is the innermost one open.  ``n`` is a host int or a 0-d device
tensor: a device value is summed on the device, with no synchronisation,
and becomes an int when the span's device times are resolved.  A
*device* span also records a CUDA event at each end, and its
``device_ms`` is the stream's time between them; on the CPU it is the
host's.  ``self_ns`` is the span's host time less the host time of the
spans opened inside it.

``recording(device, clock=..., model=...)`` records one step: it opens
the ``step`` span, installs forward hooks on the model's layer slots
(``block`` spans, or ``recompute`` spans, with CUDA events, where a
slot's forward runs inside a ``backward`` span: the checkpoint's
replay), and on exit removes them and keeps the step's spans.  The
trainer records whenever it is handed a clock other than ``NO_CLOCK``.
``recorded()`` returns the spans of the last ``KEEP_STEPS`` recorded
steps, their device times and counters resolved; ``reset()`` forgets
them.  While nothing is recorded ``span(...)`` returns one shared null
context and ``count`` does nothing: no hook, no CUDA event, no
allocation; ``active()`` says whether a step is being recorded, so that
a caller computes a device counter's value only then.

A ``StageClock`` marks the end of each stage of a step; the time from
one mark (or the clock's creation) to the next goes to the later mark's
stage, summed over repeated marks (``stage_ms``).  Each mark is a span
of kind ``"stage"``, kept with the step while one is being recorded: on
a CUDA device the marks are CUDA events recorded on the current stream,
so timing adds no synchronisation until ``stage_ms`` is read.
``StageClock(device, then=clock)`` also passes every mark to ``clock``,
a clock that has only ``mark``.  ``NO_CLOCK`` records nothing and is the
default everywhere.

``chrome_trace(spans)`` gives the spans as Chrome-trace JSON (µs on the
shared clock, counters as ``args``), which opens beside a
``torch.profiler`` trace in Perfetto.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import time

import torch

# the recorded steps ``recorded`` keeps
KEEP_STEPS = 8


@dataclasses.dataclass(eq=False)
class Span:
    name: str
    id: int
    parent: int | None
    step: int | None
    worker: int | None
    t0: int                         # host ns, time.time_ns()
    t1: int = 0
    kind: str = "span"              # "span" | "stage"
    attrs: dict = dataclasses.field(default_factory=dict)
    counters: dict = dataclasses.field(default_factory=dict)
    child_ns: int = 0               # host ns of the spans opened inside
    events: tuple | None = None     # a device span's CUDA event pair
    device: bool = False
    device_ms: float | None = None  # resolved by ``recorded``/``ms``

    @property
    def host_ns(self) -> int:
        return self.t1 - self.t0

    @property
    def self_ns(self) -> int:
        return self.host_ns - self.child_ns

    def ms(self) -> float | None:
        """The device milliseconds of a device span or stage (the host's
        without CUDA events), None for a host span; call it once the
        device has passed the span's end.  Device counters become ints."""
        for k, v in self.counters.items():
            if isinstance(v, torch.Tensor):
                self.counters[k] = int(v)
        if self.device_ms is None and self.device:
            self.device_ms = (self.events[0].elapsed_time(self.events[1])
                              if self.events else self.host_ns * 1e-6)
        return self.device_ms


def _event(cuda: bool):
    if not cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class _Recorder:
    """The process's one recorder (see the module's docstring)."""

    def __init__(self):
        self.steps: collections.deque = collections.deque(maxlen=KEEP_STEPS)
        self.spans: list | None = None      # the step being recorded
        self.stack: list[Span] = []
        self.ids = itertools.count()
        self.step: int | None = None
        self.cuda = False

    def open(self, name: str, device: bool, worker, attrs) -> Span:
        top = self.stack[-1] if self.stack else None
        if worker is None and top is not None:
            worker = top.worker
        s = Span(name, next(self.ids), None if top is None else top.id,
                 self.step, worker, time.time_ns(), attrs=attrs,
                 device=device)
        if device:
            ev = _event(self.cuda)
            s.events = None if ev is None else (ev, None)
        self.spans.append(s)
        self.stack.append(s)
        return s

    def close(self, s: Span) -> None:
        # spans left open inside ``s`` (an exception passed through their
        # opener) close with it
        while self.stack:
            top = self.stack.pop()
            if top.events is not None:
                top.events = (top.events[0], _event(True))
            top.t1 = time.time_ns()
            if self.stack:
                self.stack[-1].child_ns += top.host_ns
            if top is s:
                return

    def in_backward(self) -> bool:
        return any(s.name == "backward" for s in self.stack)


_REC = _Recorder()


class _Open:
    """``span``'s context while recording."""

    __slots__ = ("args", "span")

    def __init__(self, *args):
        self.args = args

    def __enter__(self) -> Span:
        self.span = _REC.open(*self.args)
        return self.span

    def __exit__(self, *exc) -> None:
        _REC.close(self.span)


_NULL = contextlib.nullcontext()


def span(name: str, *, device: bool = False, worker: int | None = None,
         **attrs):
    """A context that records the span ``name`` while a step is being
    recorded (with CUDA events where ``device``), else the shared null
    context.  A span without ``worker`` takes its parent's."""
    if _REC.spans is None:
        return _NULL
    return _Open(name, device, worker, attrs)


def active() -> bool:
    """Whether a step is being recorded."""
    return _REC.spans is not None


def count(name: str, n: int | torch.Tensor = 1) -> None:
    """Add ``n`` (a host int, or a 0-d device tensor that is resolved with
    the device times) to the counter ``name`` of the innermost open
    span."""
    if _REC.stack:
        c = _REC.stack[-1].counters
        c[name] = c.get(name, 0) + n


def _hook_layers(model) -> list:
    """Forward hooks on each of ``model.layers``: a ``block`` span around
    a slot's forward, or a ``recompute`` device span where it runs inside
    a backward (the checkpoint's replay).  Returns the hooks' handles."""
    handles = []
    for i, layer in enumerate(model.layers):
        opened: list[Span] = []

        def pre(mod, args, i=i, opened=opened):
            back = _REC.in_backward()
            opened.append(_REC.open("recompute" if back else "block", back,
                                    None, {"slot": i}))

        def post(mod, args, out, opened=opened):
            _REC.close(opened.pop())

        handles.append(layer.register_forward_pre_hook(pre))
        # always: a replay that the checkpoint stops early raises through
        handles.append(layer.register_forward_hook(post, always_call=True))
    return handles


class StageClock:
    """Stage marks of a step (see the module's docstring)."""

    def __init__(self, device, *, then=None):
        self.cuda = torch.device(device).type == "cuda"
        self.then = then
        self.stages: list[Span] = []
        self._last = (time.time_ns(), _event(self.cuda))

    def mark(self, stage: str) -> None:
        now = (time.time_ns(), _event(self.cuda))
        s = Span(stage, next(_REC.ids), None, _REC.step, None,
                 self._last[0], now[0], kind="stage", device=True,
                 events=(self._last[1], now[1]) if self.cuda else None)
        self._last = now
        self.stages.append(s)
        if _REC.spans is not None:
            _REC.spans.append(s)
        if self.then is not None:
            self.then.mark(stage)

    def stage_ms(self) -> dict[str, float]:
        """Milliseconds per stage, in the order stages first appeared."""
        if self.cuda:
            torch.cuda.synchronize()
        out: dict[str, float] = collections.defaultdict(float)
        for s in self.stages:
            out[s.name] += s.ms()
        return dict(out)


@contextlib.contextmanager
def recording(device, *, clock=None, model=None, step: int | None = None):
    """Record one step: yields the ``StageClock`` to mark its stages with
    (``clock`` itself where it is one, else one that passes its marks on
    to ``clock``).  Inside a step already being recorded it records into
    that step."""
    device = torch.device(device)
    if not isinstance(clock, StageClock):
        clock = StageClock(device, then=clock)
    if _REC.spans is not None:
        yield clock
        return
    _REC.spans, _REC.step = [], step
    _REC.cuda = device.type == "cuda"
    handles = [] if model is None else _hook_layers(model)
    top = _REC.open("step", False, None, {})
    try:
        yield clock
    finally:
        _REC.close(top)
        for h in handles:
            h.remove()
        _REC.steps.append(_REC.spans)
        _REC.spans, _REC.step = None, None


def recorded() -> list[Span]:
    """The spans of the last ``KEEP_STEPS`` recorded steps, in the order
    they opened (stages in the order they ended), device times and
    counters resolved (a synchronisation where any are CUDA events)."""
    spans = [s for step in _REC.steps for s in step]
    if any(s.events for s in spans):
        torch.cuda.synchronize()
    for s in spans:
        s.ms()
    return spans


def reset() -> None:
    """Forget the recorded steps."""
    _REC.steps.clear()


def totals(name: str, spans: list[Span] | None = None) -> dict:
    """``calls`` (spans named ``name``), their counters summed, and ``ms``
    (their device milliseconds), over ``spans`` (the last recorded
    step's by default)."""
    if spans is None:
        spans = list(_REC.steps[-1]) if _REC.steps else []
        if any(s.events for s in spans):
            torch.cuda.synchronize()
    out = {"calls": 0, "ms": 0.0}
    for s in spans:
        if s.name == name and s.kind == "span":
            out["calls"] += 1
            out["ms"] += s.ms() or 0.0
            for k, v in s.counters.items():
                out[k] = out.get(k, 0) + v
    return out


def chrome_trace(spans: list[Span]) -> dict:
    """Chrome-trace JSON of ``spans``: complete events in µs of the host's
    clock, the program's spans on one track and the stages on another,
    with each span's ids, step, worker, attributes, counters and device
    milliseconds as ``args``."""
    pid = os.getpid()
    events = [{"name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
               "args": {"name": name}}
              for tid, name in ((0, "spans"), (1, "stages"))]
    for s in spans:
        args = {"id": s.id, "parent": s.parent, "step": s.step,
                "worker": s.worker, **s.attrs, **s.counters}
        if s.device_ms is not None:
            args["device_ms"] = s.device_ms
        events.append({"name": s.name, "cat": s.kind, "ph": "X",
                       "ts": s.t0 / 1e3, "dur": s.host_ns / 1e3, "pid": pid,
                       "tid": int(s.kind == "stage"), "args": args})
    return {"traceEvents": events, "displayTimeUnit": "ms"}


class Renamed:
    """A view of ``clock`` that books every mark to one ``stage``."""

    def __init__(self, clock, stage: str):
        self.clock = clock
        self.stage = stage

    def mark(self, stage: str) -> None:
        self.clock.mark(self.stage)


class _NoClock:
    def mark(self, stage: str) -> None:
        pass


NO_CLOCK = _NoClock()
