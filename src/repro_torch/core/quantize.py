"""Bucketed stochastic quantization Q_l (paper Sec. 3): the shared pieces.

A flat gradient is padded to a multiple of ``bucket_size``, reshaped to
(num_buckets, bucket_size), and each bucket is normalized by its own Lq
norm.  The wire carries a signed level index per coordinate (int8, see
``code_dtype``) plus one float32 norm per bucket.  The fused kernels in
``repro_torch.kernels`` implement the encode and decode themselves.
"""
from __future__ import annotations

import torch

NORM_L2 = "l2"
NORM_LINF = "linf"
NORM_L1 = "l1"


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
