"""Per-stage timing of a train step.

A ``StageClock`` takes a mark at the end of each stage; the time between
two marks goes to the later mark's stage, summed over repeated marks.
On a CUDA device the marks are CUDA events recorded on the current
stream, so timing adds no synchronisation until ``stage_ms`` is read; on
the CPU they are host clock readings.  ``NO_CLOCK`` records nothing and
is the default everywhere.
"""
from __future__ import annotations

import collections
import time

import torch


class StageClock:
    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self._marks = [("start", self._now())]

    def _now(self):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def mark(self, stage: str) -> None:
        self._marks.append((stage, self._now()))

    def stage_ms(self) -> dict[str, float]:
        """Milliseconds per stage, in the order stages first appeared."""
        if self.cuda:
            torch.cuda.synchronize()
        out: dict[str, float] = collections.defaultdict(float)
        for (_, t0), (stage, t1) in zip(self._marks, self._marks[1:]):
            out[stage] += (t0.elapsed_time(t1) if self.cuda
                           else (t1 - t0) * 1e3)
        return dict(out)


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
