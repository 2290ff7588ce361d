"""Sufficient statistics of normalized gradient coordinates.

Normalized coordinates ``r = |v_i|/||v||`` of each bucket are modelled as
truncated normals on [0, 1] (paper App. A.2), mixed with weights
``gamma_n = ||v_n||^2 / sum ||v_n||^2`` (Sec. 3.4), or uniformly for the
"-N" objective.  Everything is closed form in (Phi, phi), so every
worker updates its levels from the same few scalars.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

_SQRT2PI = 2.5066282746310002
_MIN_SIGMA = 1e-4  # PDF/CDF conditioning floor (paper App. K)


def _phi(z):
    return torch.exp(-0.5 * z * z) / _SQRT2PI


def _Phi(z):
    return 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))


class TruncNormStats(NamedTuple):
    """A mixture of truncated normals on [0, 1].

    Fields are vectors over mixture components: location ``mu``, scale
    ``sigma`` of the parent normal, and weight ``gamma`` (sums to 1).
    """

    mu: torch.Tensor
    sigma: torch.Tensor
    gamma: torch.Tensor

    @property
    def n_components(self) -> int:
        return self.mu.shape[0]


def _as_tensor(x, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _z(stats: TruncNormStats, x):
    x = _as_tensor(x, stats.mu)
    return (x[..., None] - stats.mu) / stats.sigma


def _normalizer(stats: TruncNormStats):
    """Phi((1-mu)/sig) - Phi((0-mu)/sig), clamped away from zero."""
    hi = _Phi((1.0 - stats.mu) / stats.sigma)
    lo = _Phi((0.0 - stats.mu) / stats.sigma)
    return torch.clamp(hi - lo, min=1e-12), lo


def mixture_pdf(stats: TruncNormStats, x) -> torch.Tensor:
    """p(x) = sum_n gamma_n p_n(x) on [0, 1]."""
    Z, _ = _normalizer(stats)
    p = _phi(_z(stats, x)) / (stats.sigma * Z)
    x = _as_tensor(x, stats.mu)[..., None]
    p = torch.where((x >= 0.0) & (x <= 1.0), p, torch.zeros_like(p))
    return torch.sum(stats.gamma * p, dim=-1)


def _component_cdf(stats: TruncNormStats, x):
    Z, lo = _normalizer(stats)
    return torch.clamp((_Phi(_z(stats, x)) - lo) / Z, 0.0, 1.0)


def _component_pdf(stats: TruncNormStats, x):
    Z, _ = _normalizer(stats)
    return _phi(_z(stats, x)) / (stats.sigma * Z)


def mixture_cdf(stats: TruncNormStats, x) -> torch.Tensor:
    """F(x) = sum_n gamma_n F_n(x); F(x<=0)=0, F(x>=1)=1."""
    return torch.sum(stats.gamma * _component_cdf(stats, x), dim=-1)


def partial_moment0(stats: TruncNormStats, a, c) -> torch.Tensor:
    """int_a^c dF(r) = F(c) - F(a)."""
    return mixture_cdf(stats, c) - mixture_cdf(stats, a)


def partial_moment1(stats: TruncNormStats, a, c) -> torch.Tensor:
    """int_a^c r dF(r) = mu (F(c)-F(a)) - sigma^2 (p(c)-p(a)) per
    component (paper App. B.1)."""
    Fc, Fa = _component_cdf(stats, c), _component_cdf(stats, a)
    pc, pa = _component_pdf(stats, c), _component_pdf(stats, a)
    m1 = stats.mu * (Fc - Fa) - stats.sigma ** 2 * (pc - pa)
    return torch.sum(stats.gamma * m1, dim=-1)


def partial_moment2(stats: TruncNormStats, a, c) -> torch.Tensor:
    """int_a^c r^2 dF(r) = mu*m1 + sigma^2 (F(c)-F(a))
    - sigma^2 (c p(c) - a p(a))."""
    a_, c_ = _as_tensor(a, stats.mu), _as_tensor(c, stats.mu)
    Fc, Fa = _component_cdf(stats, c), _component_cdf(stats, a)
    pc, pa = _component_pdf(stats, c), _component_pdf(stats, a)
    m1 = stats.mu * (Fc - Fa) - stats.sigma ** 2 * (pc - pa)
    m2 = stats.mu * m1 + stats.sigma ** 2 * (Fc - Fa) - stats.sigma ** 2 * (
        c_[..., None] * pc - a_[..., None] * pa)
    return torch.sum(stats.gamma * m2, dim=-1)


def mixture_inverse_cdf(stats: TruncNormStats, y, iters: int = 50
                        ) -> torch.Tensor:
    """F^{-1}(y) by bisection on [0, 1] (the mixture CDF has no closed
    inverse)."""
    y = _as_tensor(y, stats.mu)
    lo, hi = torch.zeros_like(y), torch.ones_like(y)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        below = mixture_cdf(stats, mid) < y
        lo, hi = torch.where(below, mid, lo), torch.where(below, hi, mid)
    return 0.5 * (lo + hi)


def single_trunc_norm_inverse_cdf(mu, sigma, y) -> torch.Tensor:
    """Closed-form inverse for one truncated normal (App. A.2, Eq. 18)."""
    mu, sigma, y = (torch.as_tensor(t, dtype=torch.float32)
                    for t in (mu, sigma, y))
    Phi_a = _Phi((0.0 - mu) / sigma)
    Phi_b = _Phi((1.0 - mu) / sigma)
    ybar = (Phi_b - Phi_a) * y + Phi_a
    return sigma * torch.special.ndtri(
        torch.clamp(ybar, 1e-12, 1.0 - 1e-12)) + mu


def expected_variance(stats: TruncNormStats, levels: torch.Tensor
                      ) -> torch.Tensor:
    """Psi(l) = sum_j int_{l_j}^{l_{j+1}} (l_{j+1}-r)(r-l_j) dF(r) (Eq. 3)."""
    a = levels[:-1]
    c = levels[1:]
    m0 = partial_moment0(stats, a, c)
    m1 = partial_moment1(stats, a, c)
    m2 = partial_moment2(stats, a, c)
    return torch.sum(-m2 + (a + c) * m1 - a * c * m0)


def stats_from_moments(mu: torch.Tensor, var: torch.Tensor,
                       bucket_norms: torch.Tensor, *, weighted: bool = True,
                       max_components: int = 64) -> TruncNormStats:
    """Mixture from per-bucket first/second moments of |r|: a strided
    subsample of at most ``max_components`` buckets, re-weighted."""
    sigma = torch.clamp(torch.sqrt(var), min=_MIN_SIGMA)
    nb = mu.shape[0]
    if nb > max_components:
        stride = nb // max_components
        idx = torch.arange(max_components, device=mu.device) * stride
        mu, sigma, bucket_norms = mu[idx], sigma[idx], bucket_norms[idx]
    w = bucket_norms ** 2 if weighted else torch.ones_like(bucket_norms)
    gamma = w / torch.clamp(torch.sum(w), min=1e-30)
    return TruncNormStats(mu=mu, sigma=sigma, gamma=gamma)


def fit_bucket_stats(r: torch.Tensor, bucket_norms: torch.Tensor, *,
                     weighted: bool = True, max_components: int = 64,
                     mask: torch.Tensor | None = None) -> TruncNormStats:
    """Fit per-bucket (mu, sigma) of normalized magnitudes r (nb,
    bucket_size) normalized by ``bucket_norms`` (nb,); ``mask`` (nb,
    bucket_size) marks the valid coordinates (not padding)."""
    if mask is None:
        mu = torch.mean(r, dim=1)
        var = torch.var(r, dim=1, correction=0)
    else:
        cnt = torch.clamp(torch.sum(mask, dim=1), min=1.0)
        mu = torch.sum(r * mask, dim=1) / cnt
        var = torch.sum(mask * (r - mu[:, None]) ** 2, dim=1) / cnt
    return stats_from_moments(mu, var, bucket_norms, weighted=weighted,
                              max_components=max_components)


def merge_stats(stacked: TruncNormStats) -> TruncNormStats:
    """Combine the M workers' mixtures: each field is (M, K), worker-major.

    The components are concatenated in worker order and the weights
    renormalized globally, as the reference's all_gather merge does.
    """
    gamma = stacked.gamma.reshape(-1)
    return TruncNormStats(mu=stacked.mu.reshape(-1),
                          sigma=stacked.sigma.reshape(-1),
                          gamma=gamma / torch.clamp(torch.sum(gamma),
                                                    min=1e-30))
