"""The training traffic of a cell: each step's token rows and each
worker's rounding uniforms, made from the run's seed.

A traffic file (``traffic/<name>.json``) fixes the job: the workers, each
worker's rows and their length, how tokens are drawn, the quantization
scheme and wire, the optimizer and the level-update schedule.  Every
seed gets the same sizes; the seed changes only the values.

Step t's rows are drawn on the host, ``workers * rows_per_worker`` rows
of ``seq_len + 1`` tokens (ids are a row's first ``seq_len`` tokens,
labels its last), so that every row of every step differs.  Worker w's
uniforms of step t, one a coordinate of its bucketed gradient, are drawn
on the device by a generator of their own, so that the program and the
reference draw the same ones from the seed alone.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from .weights import derive

_ROWS, _UNIFORMS = 0xBA7C, 0x0FF1
TOKEN_KINDS = ("uniform",)


class Traffic(NamedTuple):
    name: str
    workers: int
    rows_per_worker: int
    seq_len: int
    tokens: str
    scheme: dict
    sync_mode: str
    codec: str
    compress: str
    integrity: bool
    optimizer: dict
    update_milestones: tuple
    update_every: int

    @property
    def rows(self) -> int:
        return self.workers * self.rows_per_worker

    @property
    def tokens_per_step(self) -> int:
        return self.rows * self.seq_len

    @property
    def quantized(self) -> bool:
        return (self.sync_mode != "fp32"
                and self.scheme["name"] not in ("fp32", "super_sgd"))

    def is_update_step(self, step: int) -> bool:
        """The trainer's schedule: a milestone, or every ``update_every``
        steps after step 0."""
        return step in self.update_milestones or (
            self.update_every > 0 and step > 0
            and step % self.update_every == 0)


def load(path: Path) -> Traffic:
    raw = json.loads(Path(path).read_text())
    t = Traffic(name=Path(path).stem, workers=raw["workers"],
                rows_per_worker=raw["rows_per_worker"],
                seq_len=raw["seq_len"], tokens=raw["tokens"],
                scheme=raw["scheme"], sync_mode=raw["sync_mode"],
                codec=raw.get("codec", "uniform"),
                compress=raw.get("compress", "plain"),
                integrity=raw.get("integrity", False),
                optimizer=raw["optimizer"],
                update_milestones=tuple(raw["update_milestones"]),
                update_every=raw["update_every"])
    if t.tokens not in TOKEN_KINDS:
        raise ValueError(f"{path}: tokens {t.tokens!r}; known: {TOKEN_KINDS}")
    return t


def rows(traffic: Traffic, vocab: int, seed: int, step: int, device
         ) -> dict[str, torch.Tensor]:
    """Step ``step``'s global batch: ids and labels, (rows, seq_len)
    int64 on ``device``, worker w's rows at [w * rows_per_worker, ...)."""
    rng = np.random.default_rng(np.random.SeedSequence(
        [seed, _ROWS, step]))
    toks = rng.integers(0, vocab, size=(traffic.rows, traffic.seq_len + 1),
                        dtype=np.int64)
    t = torch.from_numpy(toks).to(device)
    return {"ids": t[:, :-1], "labels": t[:, 1:]}


def uniforms(seed: int, step: int, worker: int, shape: tuple, device,
             phase: int = 1) -> torch.Tensor:
    """Worker ``worker``'s float32 rounding uniforms of step ``step``
    (``phase`` 2: of two_phase's re-quantization)."""
    gen = torch.Generator(device=device).manual_seed(
        derive(seed, _UNIFORMS, step, worker, phase))
    return torch.rand(shape, generator=gen, dtype=torch.float32,
                      device=device)


class StepUniforms:
    """Every worker's uniforms of one step, drawn when the wire asks for
    worker w's (``u[w]``), so that one worker's are held at a time, as
    when the trainer draws them from its own generators."""

    def __init__(self, seed: int, step: int, shape: tuple, device,
                 phase: int = 1):
        self.seed, self.step, self.shape, self.device, self.phase = (
            seed, step, shape, device, phase)

    def __getitem__(self, worker: int) -> torch.Tensor:
        return uniforms(self.seed, self.step, worker, self.shape,
                        self.device, self.phase)
