"""Entry points of the three bucket kernels, dispatched by tensor device.

A tensor on the CPU goes to the plain PyTorch version (``ref``); a CUDA
tensor goes to the CUDA kernel, which either launches or raises.  There
is no other path: nothing falls back and nothing moves between devices.

``LAUNCHES`` (from ``cuda``) counts the kernel launches; the CPU
versions do not count.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import NORM_L2
from . import ref
from .bucket_stats import bucket_stats_cuda
from .cuda import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .dequantize import dequantize_cuda
from .quantize import quantize_cuda


def _route(t: torch.Tensor, op: str) -> bool:
    """True for the CUDA kernel, False for the plain version."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{op}: no kernel for device {t.device}")


def quantize_op(vb: torch.Tensor, u: torch.Tensor, levels: torch.Tensor, *,
                norm_type: str = NORM_L2
                ) -> tuple[torch.Tensor, torch.Tensor]:
    if _route(vb, "quantize"):
        return quantize_cuda(vb, u, levels, norm_type)
    return ref.quantize_ref(vb, u, levels, norm_type)


def dequantize_op(codes: torch.Tensor, norms: torch.Tensor,
                  levels: torch.Tensor) -> torch.Tensor:
    if _route(codes, "dequantize"):
        return dequantize_cuda(codes, norms, levels)
    return ref.dequantize_ref(codes, norms, levels)


def bucket_stats_op(vb: torch.Tensor, *, norm_type: str = NORM_L2
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    if _route(vb, "bucket_stats"):
        return bucket_stats_cuda(vb, norm_type)
    return ref.bucket_stats_ref(vb, norm_type)
