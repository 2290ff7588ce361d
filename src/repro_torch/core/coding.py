"""Code-length accounting (paper App. D): closed-form level occupancy
probabilities Pr(l_j) (Prop. 6) and their entropy H(L)."""
from __future__ import annotations

import torch

from .stats import TruncNormStats, partial_moment0, partial_moment1


def level_probabilities(levels: torch.Tensor, stats: TruncNormStats
                        ) -> torch.Tensor:
    """Pr(l_j) under randomized rounding (Prop. 6), closed form.

    Pr(l_j) = int_{l_{j-1}}^{l_j} (r-l_{j-1})/(l_j-l_{j-1}) dF
            + int_{l_j}^{l_{j+1}} (l_{j+1}-r)/(l_{j+1}-l_j) dF
    with one-sided variants at the endpoints.  Sums to 1; a fit that loses
    all its mass to rounding falls back to the uniform distribution.
    """
    n = levels.shape[0]
    if n == 1:
        return torch.ones(1, dtype=levels.dtype, device=levels.device)
    a, b = levels[:-1], levels[1:]
    gap = torch.clamp(b - a, min=1e-12)
    m0 = partial_moment0(stats, a, b)
    m1 = partial_moment1(stats, a, b)
    up = (m1 - a * m0) / gap      # mass rounded up from each bin
    down = (b * m0 - m1) / gap    # mass rounded down
    probs = torch.zeros(n, dtype=levels.dtype, device=levels.device)
    probs[1:] += up
    probs[:-1] += down
    probs = torch.clamp(probs, min=0.0)
    total = torch.sum(probs)
    uniform = torch.full_like(probs, 1.0 / n)
    return torch.where(total > 1e-12, probs / torch.clamp(total, min=1e-12),
                       uniform)


def entropy_bits(probs: torch.Tensor) -> torch.Tensor:
    """H(L) in bits."""
    p = torch.clamp(probs, 1e-12, 1.0)
    return -torch.sum(torch.where(probs > 0, probs * torch.log2(p),
                                  torch.zeros_like(p)))
