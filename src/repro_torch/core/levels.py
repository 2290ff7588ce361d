"""Quantization level grids (the object ALQ/AMQ adapt).

A level vector is ``l = [l0=0, l1, ..., ls, l_{s+1}=1]`` on the unit
interval, applied to normalized magnitudes ``r = |v_i| / ||v||``; the
sign is carried separately (paper Sec. 3).  ``bits`` b gives ``2**b``
levels on [0, 1], so s = 2**b - 2 interior levels adapt.
"""
from __future__ import annotations

import torch


def num_levels(bits: int) -> int:
    """Total number of points on [0,1] (including 0 and 1)."""
    if bits < 1:
        raise ValueError(f"bits must be >= 1, got {bits}")
    return 2 ** bits


def num_inner(bits: int) -> int:
    """Number of adaptable interior levels s."""
    return num_levels(bits) - 2


def uniform_levels(bits: int, *, device="cuda") -> torch.Tensor:
    """QSGD / QSGDinf grid: uniformly spaced levels on [0, 1].

    Level i is i * step with step the float32 of 1 / (n - 1), rounded
    as the reference package rounds it.
    """
    n = num_levels(bits)
    step = torch.tensor(1.0 / (n - 1), dtype=torch.float32, device=device)
    return torch.arange(n, dtype=torch.float32, device=device) * step


def exp_levels(bits: int, p: float = 0.5, *, device="cuda") -> torch.Tensor:
    """NUQSGD / AMQ grid: [0, p^s, ..., p^2, p, 1] (exponentially spaced)."""
    return multiplier_to_levels(
        torch.tensor(p, dtype=torch.float32, device=device), bits)


def ternary_levels(*, device="cuda") -> torch.Tensor:
    """TernGrad: levels {0, 1} under L-inf normalization (s = 0)."""
    return torch.tensor([0.0, 1.0], dtype=torch.float32, device=device)


def multiplier_to_levels(p: torch.Tensor, bits: int) -> torch.Tensor:
    """AMQ parametrization: multiplier p -> level vector [0, p^s..p, 1]."""
    n = 2 ** bits
    exps = torch.arange(n - 2, -1, -1, dtype=p.dtype, device=p.device)
    pos = p ** exps
    # the reference's compiler flushes subnormal powers to zero
    pos = torch.where(pos < torch.finfo(pos.dtype).tiny,
                      torch.zeros_like(pos), pos)
    return torch.cat([torch.zeros(1, dtype=pos.dtype, device=p.device), pos])


def is_feasible(levels: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """l in L: strictly increasing, l0 = 0, l_{s+1} = 1."""
    ok_mono = torch.all(levels[1:] - levels[:-1] > eps)
    ok_ends = (levels[0] == 0.0) & (levels[-1] == 1.0)
    return ok_mono & ok_ends


def level_gaps(levels: torch.Tensor) -> torch.Tensor:
    """delta_j = min(l_j - l_{j-1}, l_{j+1} - l_j) for interior j (Eq. 7)."""
    left = levels[1:-1] - levels[:-2]
    right = levels[2:] - levels[1:-1]
    return torch.minimum(left, right)
