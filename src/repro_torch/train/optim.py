"""Optimizers and LR schedules over flat parameter vectors.

SGD + momentum (UMSGD, App. I, Eq. 45: heavy-ball or Nesterov) and AdamW,
with the reference's formulas and its float32 scalars.  The port keeps
parameters, gradients and optimizer moments as flat (d,) tensors, so an
update is a handful of elementwise operations over d, done in place; the
moments take the aggregate's dtype, float32 from the quantized wire also
where the parameters are bfloat16.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from repro_torch import numerics


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    name: str = "sgdm"          # sgdm | adamw
    lr: float = 0.1
    momentum: float = 0.9
    nesterov: bool = False      # UMSGD l=1 vs l=0
    weight_decay: float = 1e-4
    warmup_steps: int = 0
    decay_milestones: tuple = ()   # steps at which lr *= decay_factor
    decay_factor: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8


class OptState(NamedTuple):
    mu: torch.Tensor            # momentum / first moment (d,)
    nu: torch.Tensor | None     # second moment (adamw)
    count: int


def init_opt_state(cfg: OptimConfig, flat: torch.Tensor,
                   dtype: torch.dtype = torch.float32) -> OptState:
    """Zero moments of ``dtype``, the dtype of the aggregates the updates
    will take: the reference's moments start in the parameters' dtype and
    take the aggregate's in the first update, and zeros are the same
    value in either."""
    def zeros():
        return torch.zeros_like(flat, dtype=dtype)

    return OptState(mu=zeros(), nu=zeros() if cfg.name == "adamw" else None,
                    count=0)


def schedule(cfg: OptimConfig, step: int) -> np.float32:
    """Learning rate at ``step``, rounded as the reference rounds it."""
    lr = np.float32(cfg.lr)
    if cfg.warmup_steps > 0:
        lr = lr * np.float32(min(1.0, (step + 1) / cfg.warmup_steps))
    for m in cfg.decay_milestones:
        if step >= m:
            lr = lr * np.float32(cfg.decay_factor)
    return np.float32(lr)


def _weak(x: float, t: torch.Tensor) -> float:
    """The Python scalar ``x`` as JAX applies it to ``t`` (a weak type):
    rounded to ``t``'s dtype first, so that a bfloat16 operand meets
    bfloat16(0.9), not 0.9 (a no-op for float32)."""
    return torch.tensor(x, dtype=t.dtype).item()


@torch.no_grad()
def apply_updates(cfg: OptimConfig, flat: torch.Tensor, grad: torch.Tensor,
                  state: OptState) -> OptState:
    """Updates ``flat`` in place from the aggregate ``grad`` (of the
    moments' dtype); returns the new optimizer state (its moments are
    updated in place too).  Each step rounds where the reference's
    promotions do: bfloat16 moments (from a bfloat16 aggregate) round
    each of their operations, the step's direction is float32, the
    weight decay term of bfloat16 parameters rounds to bfloat16, and the
    new parameters round once to their dtype."""
    step = state.count
    lr = float(schedule(cfg, step))
    decay = _weak(cfg.weight_decay, flat) * flat
    if cfg.name == "sgdm":
        g = grad + decay
        mom = _weak(cfg.momentum, g)
        m = state.mu.mul_(mom).add_(g)
        direction = g + mom * m if cfg.nesterov else m
        flat.sub_(lr * direction.float())   # the reference's lr is float32
        return OptState(mu=m, nu=None, count=step + 1)
    if cfg.name == "adamw":
        t = np.float32(step + 1)
        c1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
        m = state.mu.mul_(_weak(cfg.b1, grad)).add_(
            _weak(1 - cfg.b1, grad) * grad)
        v = state.nu.mul_(_weak(cfg.b2, grad)).add_(
            _weak(1 - cfg.b2, grad) * grad * grad)
        # float32 from here on: the reference's corrections are float32,
        # and it divides by them (they come from the traced step)
        upd = numerics.divide(m.float(), c1) / (
            numerics.sqrt(numerics.divide(v.float(), c2)) + cfg.eps)
        flat.sub_(lr * (upd + decay))
        return OptState(mu=m, nu=v, count=step + 1)
    raise ValueError(cfg.name)
