"""Bucketed stochastic quantization Q_l (paper Sec. 3).

A flat gradient is padded to a multiple of ``bucket_size``, reshaped to
(num_buckets, bucket_size), and each bucket is normalized by its own Lq
norm.  Each normalized magnitude is stochastically rounded to one of the
levels; the wire carries a signed level index per coordinate (int8, see
``code_dtype``) plus one float32 norm per bucket.

``encode`` and ``decode`` take the fused kernels of
``repro_torch.kernels.ops``: the CUDA kernels for a tensor on the card,
their plain versions for one on the CPU.  The randomness of the rounding
is an explicit uniform tensor ``u``, so that the reference's uniforms
can be passed in.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

NORM_L2 = "l2"
NORM_LINF = "linf"
NORM_L1 = "l1"


class QuantizedTensor(NamedTuple):
    """Wire representation of one quantized (bucketed) tensor."""

    codes: torch.Tensor  # (num_buckets, bucket_size) signed level indices
    norms: torch.Tensor  # (num_buckets,) float32 bucket norms
    dim: int             # original (unpadded) length


def code_dtype(num_levels: int) -> torch.dtype:
    """Dtype of signed level indices in [-(L-1), L-1].

    int8 covers every grid up to 128 levels (bits <= 7); only the 8-bit
    edge (256 levels, |index| up to 255) needs int16.
    """
    return torch.int8 if num_levels <= 128 else torch.int16


def bucket_norm(vb: torch.Tensor, norm_type: str) -> torch.Tensor:
    """Per-bucket Lq norm; vb is (num_buckets, bucket_size)."""
    if norm_type == NORM_L2:
        return torch.sqrt(torch.sum(vb * vb, dim=-1))
    if norm_type == NORM_LINF:
        return torch.amax(torch.abs(vb), dim=-1)
    if norm_type == NORM_L1:
        return torch.sum(torch.abs(vb), dim=-1)
    raise ValueError(f"unknown norm {norm_type!r}")


def pad_to_buckets(v: torch.Tensor, bucket_size: int) -> torch.Tensor:
    """Flatten and zero-pad to a bucket multiple -> (nb, bucket_size)."""
    flat = v.reshape(-1)
    nb = -(-flat.numel() // bucket_size)
    pad = nb * bucket_size - flat.numel()
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.reshape(nb, bucket_size)


def rounding_interval(r: torch.Tensor, levels: torch.Tensor
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each r's lower level index tau (clipped to [0, L-2]) and its
    probability rho of rounding up to tau + 1."""
    tau = torch.searchsorted(levels, r.contiguous(), right=True) - 1
    tau = torch.clamp(tau, 0, levels.shape[0] - 2)
    lo, hi = levels[tau], levels[tau + 1]
    return tau, (r - lo) / torch.clamp(hi - lo, min=1e-30)


def normalized_magnitudes(v: torch.Tensor, bucket_size: int, norm_type: str
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Returns (r, norms): r in [0, 1], shape (nb, bucket_size)."""
    vb = pad_to_buckets(v, bucket_size)
    norms = bucket_norm(vb, norm_type)
    safe = torch.where(norms > 0, norms, torch.ones_like(norms))
    return torch.clamp(torch.abs(vb) / safe[:, None], 0.0, 1.0), norms


def clip_coordinates(v: torch.Tensor, clip_sigmas: float) -> torch.Tensor:
    """TernGrad-style pre-quantization clipping (paper Eq. 49)."""
    c = clip_sigmas * torch.std(v, correction=0)
    return torch.clamp(v, -c, c)


def stochastic_round(r: torch.Tensor, levels: torch.Tensor,
                     u: torch.Tensor) -> torch.Tensor:
    """Map r in [0, 1] to a level index with unbiased randomized rounding;
    ``u`` ~ Uniform[0, 1) of r's shape.  Returns int32 indices."""
    tau, rho = rounding_interval(r, levels)
    return (tau + (u < rho)).to(torch.int32)


def encode(v: torch.Tensor, levels: torch.Tensor, u: torch.Tensor, *,
           bucket_size: int, norm_type: str = NORM_L2) -> QuantizedTensor:
    """ENCODE_l(v): signed level indices + bucket norms, with the
    uniforms ``u`` of shape (nb, bucket_size)."""
    from repro_torch.kernels import ops
    codes, norms = ops.quantize_op(pad_to_buckets(v, bucket_size), u, levels,
                                   norm_type=norm_type)
    return QuantizedTensor(codes=codes, norms=norms, dim=v.numel())


def decode(qt: QuantizedTensor, levels: torch.Tensor) -> torch.Tensor:
    """DECODE_l: back to a flat float32 vector of length qt.dim."""
    from repro_torch.kernels import ops
    return ops.dequantize_op(qt.codes, qt.norms, levels).reshape(-1)[:qt.dim]


def quantize(v: torch.Tensor, levels: torch.Tensor, u: torch.Tensor, *,
             bucket_size: int, norm_type: str = NORM_L2) -> torch.Tensor:
    """Q_l(v) = DECODE(ENCODE(v)) with the original shape restored."""
    qt = encode(v, levels, u, bucket_size=bucket_size, norm_type=norm_type)
    return decode(qt, levels).reshape(v.shape)


def quantization_variance(v: torch.Tensor, levels: torch.Tensor, *,
                          bucket_size: int, norm_type: str = NORM_L2
                          ) -> torch.Tensor:
    """Exact E_h ||Q(v) - v||^2 (Eqs. 1-2): the sum over coordinates of
    ||v||^2 (l_{tau+1} - r)(r - l_tau)."""
    r, norms = normalized_magnitudes(v, bucket_size, norm_type)
    tau, _ = rounding_interval(r, levels)
    per_coord = (levels[tau + 1] - r) * (r - levels[tau])
    return torch.sum(norms[:, None] ** 2 * per_coord)
