"""The plain reference of the quantized wire and of the level update
(the paper's Algorithm 1, lines 2-9), in plain PyTorch.

Quantization: a worker's gradient, zero-padded to buckets of
``bucket_size``, is normalized by each bucket's L2 norm, and each
normalized magnitude r is rounded to one of the levels stochastically
and without bias: up from level tau to tau + 1 when the uniform u < (r -
l_tau) / (l_{tau+1} - l_tau).  The aggregate is the mean over the workers
of norm * level * sign.  Packing, the exchange and unpacking are lossless
and have no counterpart here.

The two_phase wire (``requantized``) rounds each worker's shard of that
mean once more, to 8-bit uniform levels under L-inf bucket norms.  With
error feedback each worker adds its residual (what its last rounding
left out) to its gradient before rounding.

The level update (ALQ, coordinate descent): each worker's normalized
magnitudes are modelled, bucket by bucket, as truncated normals on [0, 1]
from the bucket's mean and variance (64 buckets, evenly strided, each
weighted by its squared norm), the workers' mixtures are pooled, and
every interior level is set in turn, 10 sweeps, to the minimiser of the
expected variance between its neighbours (the closed form of the paper's
Eq. 5, solved by bisection).  It runs in float64 on the host.
"""
from __future__ import annotations

import math

import torch

MAX_COMPONENTS = 64
MIN_SIGMA = 1e-4
SWEEPS = 10
BISECT = 40
CHUNK_BUCKETS = 4096


def uniform_levels(bits: int, device) -> torch.Tensor:
    n = 2 ** bits
    step = torch.tensor(1.0 / (n - 1), dtype=torch.float32)
    return (torch.arange(n, dtype=torch.float32) * step).to(device)


def bucketed(g: torch.Tensor, bucket_size: int, nb: int) -> torch.Tensor:
    out = torch.zeros(nb * bucket_size, dtype=torch.float32, device=g.device)
    out[:g.numel()] = g
    return out.view(nb, bucket_size)


# ---- the level update ----------------------------------------------------

def worker_mixture(g: torch.Tensor, bucket_size: int
                   ) -> tuple[torch.Tensor, ...]:
    """(mu, sigma, weight) of one worker's mixture, float64 on the host:
    64 of its whole buckets, strided evenly."""
    nb = max(g.numel() // bucket_size, 1)
    idx = torch.arange(min(nb, MAX_COMPONENTS))
    if nb > MAX_COMPONENTS:
        idx = idx * (nb // MAX_COMPONENTS)
    vb = torch.stack([g[i * bucket_size:(i + 1) * bucket_size]
                      for i in idx.tolist()]).double().cpu()
    norm = torch.sqrt(torch.sum(vb * vb, -1))
    r = vb.abs() / torch.where(norm > 0, norm, 1.0)[:, None]
    mu = r.mean(-1)
    var = torch.clamp((r * r).mean(-1) - mu * mu, min=0.0)
    w = norm ** 2
    return mu, torch.clamp(torch.sqrt(var), min=MIN_SIGMA), w / w.sum()


def _Phi(z):
    return 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0)))


class Mixture:
    def __init__(self, mu, sigma, gamma):
        self.mu, self.s, self.gamma = mu, sigma, gamma / gamma.sum()
        self.lo = _Phi(-mu / sigma)
        self.Z = torch.clamp(_Phi((1.0 - mu) / sigma) - self.lo, min=1e-12)

    def _cdf_pdf(self, x):
        z = (torch.as_tensor(x, dtype=torch.float64)[..., None]
             - self.mu) / self.s
        cdf = torch.clamp((_Phi(z) - self.lo) / self.Z, 0.0, 1.0)
        pdf = torch.exp(-0.5 * z * z) / math.sqrt(2 * math.pi) / (
            self.s * self.Z)
        return cdf, pdf

    def cdf(self, x):
        return torch.sum(self.gamma * self._cdf_pdf(x)[0], -1)

    def target(self, a, c):
        """F(c) - int_a^c (r - a) / (c - a) dF(r): Eq. 4's right side."""
        (Fa, pa), (Fc, pc) = self._cdf_pdf(a), self._cdf_pdf(c)
        m0 = torch.sum(self.gamma * (Fc - Fa), -1)
        m1 = torch.sum(self.gamma * (self.mu * (Fc - Fa)
                                     - self.s ** 2 * (pc - pa)), -1)
        return self.cdf(c) - (m1 - a * m0) / max(c - a, 1e-12)


def alq_levels(levels: torch.Tensor, mixture: Mixture) -> torch.Tensor:
    lv = levels.double().cpu().tolist()
    for _ in range(SWEEPS):
        for j in range(1, len(lv) - 1):
            a, c = lv[j - 1], lv[j + 1]
            t = mixture.target(a, c)
            lo, hi = a, c
            for _ in range(BISECT):
                mid = 0.5 * (lo + hi)
                if mixture.cdf(mid) < t:
                    lo = mid
                else:
                    hi = mid
            lv[j] = min(max(0.5 * (lo + hi), a + 1e-7), c - 1e-7)
    return torch.tensor(lv, dtype=torch.float32, device=levels.device)


def update_levels(levels: torch.Tensor, grads: list[torch.Tensor],
                  bucket_size: int) -> torch.Tensor:
    parts = [worker_mixture(g, bucket_size) for g in grads]
    return alq_levels(levels, Mixture(*(torch.cat(f) for f in zip(*parts))))


# ---- the quantized mean --------------------------------------------------

def quantized(vb: torch.Tensor, u: torch.Tensor, levels: torch.Tensor,
              linf: bool = False) -> torch.Tensor:
    """Q(vb): the decoded values of (nb, bucket_size) values rounded with
    the uniforms u, under L2 bucket norms (L-inf with ``linf``)."""
    norm = (vb.abs().amax(-1) if linf
            else torch.sqrt(torch.sum(vb * vb, -1)))
    r = torch.clamp(vb.abs() / torch.where(norm > 0, norm, 1.0)[:, None],
                    0.0, 1.0)
    L = levels.numel()
    tau = torch.clamp(torch.searchsorted(levels, r, right=True) - 1, 0, L - 2)
    lo, hi = levels[tau], levels[tau + 1]
    up = u < (r - lo) / torch.clamp(hi - lo, min=1e-30)
    return levels[tau + up] * torch.sign(vb) * norm[:, None]


def quantized_mean(grads: list[torch.Tensor], levels: torch.Tensor,
                   draw, bucket_size: int, nb: int, residuals=None
                   ) -> torch.Tensor:
    """The mean over the workers of Q(g_w), worker w rounding with the
    (nb, bucket_size) uniforms ``draw(w)``: (nb, bucket_size) float32.
    With ``residuals`` (error feedback), worker w's residual becomes
    g_w - Q(g_w)."""
    d = grads[0].numel()
    acc = torch.zeros(nb, bucket_size, device=grads[0].device)
    for w, g in enumerate(grads):
        vb, u = bucketed(g, bucket_size, nb), draw(w)
        for i in range(0, nb, CHUNK_BUCKETS):
            q = quantized(vb[i:i + CHUNK_BUCKETS], u[i:i + CHUNK_BUCKETS],
                          levels)
            acc[i:i + CHUNK_BUCKETS] += q
            if residuals is not None:
                vb[i:i + CHUNK_BUCKETS] -= q
        if residuals is not None:
            residuals[w].copy_(vb.view(-1)[:d])
        del vb, u
    return acc / len(grads)


def requantized(mean: torch.Tensor, draw, workers: int, bits: int
                ) -> torch.Tensor:
    """two_phase's second hop: worker r's shard (the r-th of ``workers``
    equal runs of buckets) of the phase-1 mean rounded again, to uniform
    ``bits``-bit levels under L-inf bucket norms, with the uniforms
    ``draw(r)``; the shards decoded, (nb, bucket_size)."""
    levels = uniform_levels(bits, mean.device)
    snb = mean.shape[0] // workers
    return torch.cat([quantized(mean[r * snb:(r + 1) * snb], draw(r), levels,
                                linf=True) for r in range(workers)])
