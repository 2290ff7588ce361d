"""Plain PyTorch versions of the port's kernels.

They define what the CUDA kernels compute: ``ops`` runs them for tensors
on the CPU, and the kernels are checked against them on the card.  All
take already-bucketed inputs, ``vb`` of shape (num_buckets, bucket_size).
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import (
    bucket_norm, code_dtype, rounding_interval)
from repro_torch.numerics import reciprocal


def rounding(vb: torch.Tensor, norms: torch.Tensor, levels: torch.Tensor
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each element's lower level index tau and its probability rho of
    rounding up, under the given bucket norms."""
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    r = torch.clamp(torch.abs(vb.float()) / safe[:, None], 0.0, 1.0)
    return rounding_interval(r, levels)


def quantize_ref(vb: torch.Tensor, u: torch.Tensor, levels: torch.Tensor,
                 norm_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused bucket norm + normalize + stochastic round.

    Returns (codes, norms): signed level indices as ``code_dtype(L)`` and
    float32 norms.
    """
    norms = bucket_norm(vb.float(), norm_type)
    tau, rho = rounding(vb, norms, levels)
    codes = (tau + (u < rho)) * torch.sign(vb).to(torch.int64)
    return codes.to(code_dtype(levels.shape[0])), norms


def code_mismatches(got: torch.Tensor, want: torch.Tensor, vb: torch.Tensor,
                    u: torch.Tensor, norms: torch.Tensor,
                    levels: torch.Tensor) -> int:
    """How far two quantizations of ``vb`` with the same uniforms agree.

    Norms summed in another order may differ in the last ulp, which moves
    rho, and a code may then round the other way.  Returns the number of
    codes that differ and raises ValueError unless each differs by one
    at an element whose |u - rho| < 1e-5 under ``norms``.
    """
    bad = got != want
    n_bad = int(bad.sum())
    if n_bad:
        _, rho = rounding(vb, norms, levels)
        step = (got.int() - want.int()).abs()[bad]
        if not (bool((step == 1).all())
                and bool(((u - rho).abs()[bad] < 1e-5).all())):
            raise ValueError(f"{n_bad} codes differ away from a rounding "
                             "tie")
    return n_bad


def dequantize_ref(codes: torch.Tensor, norms: torch.Tensor,
                   levels: torch.Tensor) -> torch.Tensor:
    """Signed codes (any integer dtype) + norms -> float32 values.

    A code outside the table (|c| >= L, which only a corrupt symbol
    gives) decodes to 0, as the TPU kernel's one-hot lookup does.
    """
    idx = torch.abs(codes.long())
    L = levels.shape[0]
    mags = torch.where(idx < L, levels.float()[idx.clamp(max=L - 1)], 0.0)
    return mags * torch.sign(codes.float()) * norms[:, None]


def dequantize_mean_ref(codes: torch.Tensor, norms: torch.Tensor,
                        levels: torch.Tensor,
                        weights: torch.Tensor | None = None,
                        valid: torch.Tensor | None = None) -> torch.Tensor:
    """The decode of M streams of (nb, bs) codes with (M, nb) norms,
    averaged over the streams in worker order -> (nb, bs) float32,
    holding one decoded stream at a time.

    Without ``weights``: the sum from 0, then the product with the float32
    reciprocal of M (the reference's ``mean_workers`` as XLA compiles it,
    ``numerics.worker_mean``).
    With (M,) or (M, nb) ``weights``: ``w[0] * v[0] + w[1] * v[1] + ...``,
    each product rounded before its add (``transport._weighted_sum``);
    with an (M, nb) bool ``valid`` besides, an invalid bucket's values
    count as 0 before their weight (they may decode to NaN).
    """
    M, nb = norms.shape
    if weights is None:
        out = torch.zeros(codes.shape[1:], dtype=torch.float32,
                          device=codes.device)
        for m in range(M):
            out += dequantize_ref(codes[m], norms[m], levels)
        return out.mul_(reciprocal(M))
    if weights.dim() == 1:
        weights = weights[:, None].expand(M, nb)
    out = None
    for m in range(M):
        v = dequantize_ref(codes[m], norms[m], levels)
        if valid is not None:
            v = torch.where(valid[m][:, None], v, 0.0)
        t = weights[m][:, None] * v
        out = t if out is None else out.add_(t)
    return out


def bucket_stats_ref(vb: torch.Tensor, norm_type: str
                     ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-bucket (norm, mean_r, var_r) with r = |v| / norm."""
    norms = bucket_norm(vb.float(), norm_type)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    r = torch.abs(vb.float()) / safe[:, None]
    mu = torch.mean(r, dim=-1)
    var = torch.mean(r * r, dim=-1) - mu * mu
    return norms, mu, torch.clamp(var, min=0.0)
