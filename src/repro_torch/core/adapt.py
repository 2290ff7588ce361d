"""Adaptive level updates: ALQ (coordinate descent), projection-free GD,
and AMQ (exponential-multiplier gradient descent).

All consume a ``TruncNormStats`` mixture and are closed form in
(Phi, phi) plus bisections, so every worker computes the same levels.
Plain Python loops stand in for the reference's ``fori_loop``s; each
iteration queues a few tensor operations and none waits for the device.
"""
from __future__ import annotations

import torch

from .levels import level_gaps, multiplier_to_levels
from .stats import (
    TruncNormStats,
    expected_variance,
    mixture_cdf,
    partial_moment0,
    partial_moment1,
)


# ---------------------------------------------------------------------------
# ALQ: coordinate descent (Thm 1 / Eqs. 4-5, App. C.1)
# ---------------------------------------------------------------------------

def _cd_target(stats: TruncNormStats, a, c):
    """RHS of Eq. (4): F(c) - int_a^c (r-a)/(c-a) dF(r)."""
    m1 = partial_moment1(stats, a, c)
    m0 = partial_moment0(stats, a, c)
    frac = (m1 - a * m0) / torch.clamp(c - a, min=1e-12)
    return mixture_cdf(stats, c) - frac


def _bisect_cdf(stats: TruncNormStats, target, lo, hi, iters: int = 40):
    """Solve F(x) = target for x in [lo, hi] (F is monotone)."""
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = mixture_cdf(stats, mid) < target
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def alq_update(levels: torch.Tensor, stats: TruncNormStats, *,
               sweeps: int = 10, bisect_iters: int = 40) -> torch.Tensor:
    """ALQ: sequential CD sweeps over interior levels (Eq. 5).

    Each sub-problem is convex (Prop. 2); the update is the closed form
    l_j* = F^{-1}(F(l_{j+1}) - int (r - l_{j-1})/(l_{j+1} - l_{j-1}) dF),
    solved by bisection on [l_{j-1}, l_{j+1}].
    """
    s = levels.shape[0] - 2
    if s <= 0:
        return levels
    lv = levels.clone()
    for _ in range(sweeps):
        for j in range(1, s + 1):
            a, c = lv[j - 1], lv[j + 1]
            target = _cd_target(stats, a, c)
            new = _bisect_cdf(stats, target, a, c, iters=bisect_iters)
            # guard strict monotonicity under fp
            lv[j] = torch.minimum(torch.maximum(new, a + 1e-7), c - 1e-7)
    return lv


# ---------------------------------------------------------------------------
# Projection-free gradient descent (Eqs. 6-7, App. C.2)
# ---------------------------------------------------------------------------

def psi_gradient(levels: torch.Tensor, stats: TruncNormStats) -> torch.Tensor:
    """dPsi/dl_j = int_{l_{j-1}}^{l_j} (r - l_{j-1}) dF
                  - int_{l_j}^{l_{j+1}} (l_{j+1} - r) dF   (Eq. 6)."""
    a, b, c = levels[:-2], levels[1:-1], levels[2:]
    left = partial_moment1(stats, a, b) - a * partial_moment0(stats, a, b)
    right = c * partial_moment0(stats, b, c) - partial_moment1(stats, b, c)
    return left - right


def alq_gd_update(levels: torch.Tensor, stats: TruncNormStats, *,
                  lr: float = 0.5, steps: int = 50) -> torch.Tensor:
    """ALQG: projection-free GD, each step clipped to delta_j/2 (Eq. 7)."""
    if levels.shape[0] <= 2:
        return levels
    lv = levels
    for _ in range(steps):
        g = psi_gradient(lv, stats)
        step = torch.sign(g) * torch.minimum(lr * torch.abs(g),
                                             level_gaps(lv) / 2.0)
        lv = torch.cat([lv[:1], lv[1:-1] - step, lv[-1:]])
    return lv


# ---------------------------------------------------------------------------
# AMQ: exponential levels, single multiplier p (Sec. 3.3 / App. C.3)
# ---------------------------------------------------------------------------

def amq_objective(p: torch.Tensor, stats: TruncNormStats, bits: int
                  ) -> torch.Tensor:
    """Psi(p) for levels [0, p^s, ..., p, 1] (Eq. 32 restricted to
    [0, 1])."""
    return expected_variance(stats, multiplier_to_levels(p, bits))


def amq_gradient(p: torch.Tensor, stats: TruncNormStats, bits: int
                 ) -> torch.Tensor:
    """Closed-form dPsi/dp (Eq. 8 / App. C.3), mixture version.

    Bins are [p^{j+1}, p^j] for j = 0..s-1 plus the lowest bin [0, p^s].
    """
    s = 2 ** bits - 2
    if s <= 0:
        return torch.zeros_like(p)
    j = torch.arange(0, s, dtype=p.dtype, device=p.device)
    a = p ** (j + 1)  # lower edge
    c = p ** j        # upper edge
    m0 = partial_moment0(stats, a, c)
    m1 = partial_moment1(stats, a, c)
    # d/dp int_a^c (c - r)(r - a) dF = c'(p) int (r - a) dF
    #                                  + a'(p) int -(c - r) dF
    cprime = (j * p ** torch.clamp(j - 1, min=0)
              * torch.where(j == 0, 0.0, 1.0).to(p.dtype))
    aprime = (j + 1) * p ** j
    dbin = cprime * (m1 - a * m0) + aprime * (m1 - c * m0)
    m1_low = partial_moment1(stats, torch.zeros_like(p), p ** s)
    dlow = s * p ** (s - 1) * m1_low
    return torch.sum(dbin) + dlow


def amq_update(p: torch.Tensor, stats: TruncNormStats, *, bits: int,
               lr: float = 0.05, steps: int = 100) -> torch.Tensor:
    """GD on the multiplier with clipped steps."""
    for _ in range(steps):
        p = torch.clamp(p - lr * amq_gradient(p, stats, bits), 0.02, 0.98)
    return p
