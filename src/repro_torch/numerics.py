"""Arithmetic that rounds as the reference's does, alike on the CPU and on
the card: its means over workers and micro-batches, AdamW's divisions and
square root.

The reference divides by numbers it knows when it traces: M workers in
``stacked.mean(0)``, ``psum(x) / M`` and ``psum_scatter(x) / M``, k
micro-batches in ``g / k``.  XLA's algebraic simplifier turns each such
division into a product with the divisor's float32 reciprocal, and its
sums over the worker axis add in worker order from 0.  ``worker_mean`` and
``reciprocal`` compute exactly that: explicit adds, then a product with a
Python float, which ATen rounds alike on both devices.  ATen's own
``mean(0)`` would not: on the CPU it divides, and on the card it multiplies
by the reciprocal after adding in an order of its own (from M = 5 on, four
running sums).

A division by a number known only at run time (AdamW's bias corrections,
from the traced step) stays a division in the reference.  ``divide`` keeps
it one on both devices: it divides by a float32 tensor on the dividend's
device, since ATen's CUDA division by a Python number, or by a 0-dim CPU
tensor, multiplies by the rounded reciprocal instead.  ``sqrt`` is the
correctly rounded square root that XLA and the card compute; ATen's CPU
float32 kernel is off by an ulp at about 0.7% of values.
"""
from __future__ import annotations

import numpy as np
import torch


def reciprocal(n: int) -> float:
    """The float32 reciprocal of ``n`` (as a Python float, exact): what XLA
    multiplies by where the reference divides by the constant ``n``."""
    return float(np.float32(1) / np.float32(n))


def worker_mean(stacked: torch.Tensor) -> torch.Tensor:
    """The mean over the leading (worker) axis of ``stacked``, (M, ...) ->
    (...): the rows added in worker order from 0 in float32, times
    ``reciprocal(M)``, in ``stacked``'s dtype."""
    out = torch.zeros(stacked.shape[1:], dtype=torch.float32,
                      device=stacked.device)
    for row in stacked:
        out += row
    return out.mul_(reciprocal(stacked.shape[0])).to(stacked.dtype)


def divide(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` rounded once, on either device: ``c`` as a float32 tensor
    on ``x``'s device."""
    return x / torch.full((), c, dtype=torch.float32, device=x.device)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded square root of a float32 ``x``.  The card's
    kernel is; on the CPU the root is taken in float64 and rounded once,
    which is exact for a square root."""
    if x.device.type == "cpu":
        return torch.sqrt(x.double()).float()
    return torch.sqrt(x)
