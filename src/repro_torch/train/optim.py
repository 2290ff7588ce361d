"""Optimizers and LR schedules over flat parameter vectors.

SGD + momentum (UMSGD, App. I, Eq. 45: heavy-ball or Nesterov) and AdamW,
with the reference's formulas and its float32 scalars.  The port keeps
parameters, gradients and optimizer moments as flat (d,) tensors, so an
update is a handful of elementwise operations over d, done in place.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch


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


def init_opt_state(cfg: OptimConfig, flat: torch.Tensor) -> OptState:
    nu = torch.zeros_like(flat) if cfg.name == "adamw" else None
    return OptState(mu=torch.zeros_like(flat), nu=nu, count=0)


def schedule(cfg: OptimConfig, step: int) -> np.float32:
    """Learning rate at ``step``, rounded as the reference rounds it."""
    lr = np.float32(cfg.lr)
    if cfg.warmup_steps > 0:
        lr = lr * np.float32(min(1.0, (step + 1) / cfg.warmup_steps))
    for m in cfg.decay_milestones:
        if step >= m:
            lr = lr * np.float32(cfg.decay_factor)
    return np.float32(lr)


@torch.no_grad()
def apply_updates(cfg: OptimConfig, flat: torch.Tensor, grad: torch.Tensor,
                  state: OptState) -> OptState:
    """Updates ``flat`` in place from the aggregated ``grad``; returns the
    new optimizer state (its moments are updated in place too)."""
    step = state.count
    lr = float(schedule(cfg, step))
    if cfg.name == "sgdm":
        g = grad + cfg.weight_decay * flat
        m = state.mu.mul_(cfg.momentum).add_(g)
        direction = g + cfg.momentum * m if cfg.nesterov else m
        flat.sub_(lr * direction)
        return OptState(mu=m, nu=None, count=step + 1)
    if cfg.name == "adamw":
        t = np.float32(step + 1)
        c1 = float(np.float32(1.0) - np.float32(cfg.b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(cfg.b2) ** t)
        m = state.mu.mul_(cfg.b1).add_((1 - cfg.b1) * grad)
        v = state.nu.mul_(cfg.b2).add_((1 - cfg.b2) * grad * grad)
        upd = (m / c1) / (torch.sqrt(v / c2) + cfg.eps)
        flat.sub_(lr * (upd + cfg.weight_decay * flat))
        return OptState(mu=m, nu=v, count=step + 1)
    raise ValueError(cfg.name)
