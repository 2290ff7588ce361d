"""The system under test: the port's trainer, built as its training
launcher builds it, from a configuration's numbers and a traffic file.

``Program`` owns one ``Trainer`` and drives ``Trainer.train_step`` on
the harness's rows, with each worker's rounding uniforms given
(``traffic.StepUniforms``) so that the reference can draw the same ones.
Its transport is ``CountingTransport``, which counts the bytes each
worker hands to a collective.  ``BenchClock`` is what the trainer's
``clock=`` gets in a traced run.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core.schemes import QuantScheme
from repro_torch.dist.transport import StackedTransport
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import Model
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

from . import shapes, traffic as traffic_lib, weights


class CountingTransport(StackedTransport):
    """The stacked transport of M workers on one device, counting what
    each worker puts on the wire: every tensor of one dimension or more
    handed to ``all_gather``, ``all_to_all``, ``mean_psum`` (the plain
    wire's mean-allreduce) and ``reduce_scatter_mean``.  The 0-d metrics
    the trainer gathers beside them (each worker's loss and quantization
    error) are not the gradient's wire and are not counted."""

    def __init__(self, size: int):
        super().__init__(size)
        self.bytes = 0

    def _count(self, tensors) -> None:
        self.bytes += sum(t.numel() * t.element_size() for t in tensors
                          if t.dim() >= 1)

    def all_gather(self, per_worker):
        self._count(per_worker)
        return super().all_gather(per_worker)

    def all_to_all(self, per_worker):
        self._count(per_worker)
        return super().all_to_all(per_worker)

    def mean_psum(self, stacked):
        self._count([stacked])
        return super().mean_psum(stacked)

    def reduce_scatter_mean(self, rows):
        self._count([rows])
        return super().reduce_scatter_mean(rows)

    def bits_per_coord(self, steps: int, d: int) -> float:
        """Bits each worker put on the wire a step, per coordinate."""
        return 8.0 * self.bytes / (steps * self.size() * d)


class BenchClock:
    """The trainer's stage clock in a traced run: at each ``mark(stage)``
    a CUDA event (the device time since the last mark is the stage's) and
    the host's wall clock in ns, the clock of the profiler's device
    events, by which the trace's idle gaps are named."""

    def __init__(self):
        self.marks = [("start", self._event(), time.time_ns())]

    @staticmethod
    def _event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def mark(self, stage: str) -> None:
        self.marks.append((stage, self._event(), time.time_ns()))

    def stage_ms(self) -> dict[str, float]:
        torch.cuda.synchronize()
        out: dict[str, float] = {}
        for (_, e0, _), (stage, e1, _) in zip(self.marks, self.marks[1:]):
            out[stage] = out.get(stage, 0.0) + e0.elapsed_time(e1)
        return out


def model_config(m: dict) -> ModelConfig:
    """The port's configuration object of the numbers ``m`` (a key it
    does not know raises)."""
    return ModelConfig(**m)


def train_config(tr: traffic_lib.Traffic) -> TrainConfig:
    sc, opt = tr.scheme, tr.optimizer
    return TrainConfig(
        scheme=QuantScheme(name=sc["name"], bits=sc["bits"],
                           bucket_size=sc["bucket_size"]),
        optim=OptimConfig(name=opt["name"], lr=opt["lr"],
                          weight_decay=opt.get("weight_decay", 0.0),
                          b1=opt.get("b1", 0.9), b2=opt.get("b2", 0.95),
                          eps=opt.get("eps", 1e-8)),
        sync_mode=tr.sync_mode, update_milestones=tr.update_milestones,
        update_every=tr.update_every, workers=tr.workers,
        codec=tr.codec, compress=tr.compress, integrity=tr.integrity)


class Program:
    """One trainer of the configuration ``m`` under the traffic ``tr``,
    with the weights of ``seed``."""

    def __init__(self, m: dict, tr: traffic_lib.Traffic, seed: int, device):
        self.m, self.tr, self.seed = m, tr, seed
        self.device = torch.device(device)
        self.model = Model(model_config(m), device=self.device, seed=seed)
        weights.fill(self.model.flat.data, m, seed)
        self.transport = CountingTransport(tr.workers)
        self.trainer = Trainer(self.model, train_config(tr), seed=seed,
                               transport=self.transport)
        self.d = self.model.d
        bs = tr.scheme["bucket_size"]
        # two_phase lays the payload out in M shards, and re-quantizes
        # each worker's shard of the mean
        shards = tr.workers if tr.sync_mode == "two_phase" else 1
        nb = shapes.wire_buckets(self.d, bs, shards)
        self.u_shapes = ((nb, bs), (nb // shards, bs))
        self.step = 0

    def train_step(self, clock=None) -> dict:
        """One step on the next rows; the trainer's metrics (read, so the
        step has ended on the device)."""
        batch = traffic_lib.rows(self.tr, self.m["vocab_size"], self.seed,
                                 self.step, self.device)
        u = [traffic_lib.StepUniforms(self.seed, self.step, shape,
                                      self.device, phase)
             if self.tr.quantized else None
             for phase, shape in enumerate(self.u_shapes, 1)]
        kw = {} if clock is None else {"clock": clock}
        out = self.trainer.train_step(batch, u=u[0], u2=u[1], **kw)
        self.step += 1
        return out


def timed_steps(prog: Program, seconds: float
                ) -> tuple[int, float, int, list]:
    """Whole steps until ``seconds`` have passed: (steps, seconds they
    took on the host clock, to the end of the last one on the device,
    steps whose loss was not finite, each step's end in seconds from the
    start).  A step ends when its metrics are read, on the device too."""
    failed, ends, t0 = 0, [], time.perf_counter()
    while True:
        failed += not math.isfinite(prog.train_step()["loss"])
        ends.append(time.perf_counter() - t0)
        if ends[-1] >= seconds:
            break
    if prog.device.type == "cuda":
        torch.cuda.synchronize()
    return len(ends), time.perf_counter() - t0, failed, ends
