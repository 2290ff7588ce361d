"""Entry points of the three bucket kernels, dispatched by tensor device.

A tensor on the CPU goes to the plain PyTorch version (``ref``); a CUDA
tensor goes to the CUDA kernel, which either launches or raises.  A
tensor on the ``meta`` device goes to the kernel as one operator
(``*_meta``, a ``torch.library.custom_op``), whose fake gives its
outputs' shapes and dtypes and computes nothing: meta tensors only carry
shapes, for the dry run's cost count (``launch.op_cost``) of the route
the card runs.  The card's route calls the launch function itself and
pays no custom-op dispatch.  There is no other path: nothing falls back
and nothing moves between devices.

``LAUNCHES`` (from ``cuda``) counts the kernel launches; the CPU
versions do not count.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import NORM_L2
from . import ref
from .bucket_stats import bucket_stats_cuda, bucket_stats_meta
from .cuda import LAUNCHES, reset_launches  # noqa: F401  (re-exported)
from .dequantize import dequantize_cuda, dequantize_meta
from .quantize import quantize_cuda, quantize_meta


def _route(t: torch.Tensor, op: str) -> str:
    """``"cuda"`` for the CUDA kernel, ``"cpu"`` for the plain version,
    ``"meta"`` for the kernel's operator, whose fake carries shapes only."""
    kind = t.device.type
    if kind in ("cuda", "cpu", "meta"):
        return kind
    raise ValueError(f"{op}: no kernel for device {t.device}")


def quantize_op(vb: torch.Tensor, u: torch.Tensor, levels: torch.Tensor, *,
                norm_type: str = NORM_L2
                ) -> tuple[torch.Tensor, torch.Tensor]:
    route = _route(vb, "quantize")
    if route == "cuda":
        return quantize_cuda(vb, u, levels, norm_type)
    if route == "meta":
        return quantize_meta(vb, u, levels, norm_type)
    return ref.quantize_ref(vb, u, levels, norm_type)


def dequantize_op(codes: torch.Tensor, norms: torch.Tensor,
                  levels: torch.Tensor) -> torch.Tensor:
    route = _route(codes, "dequantize")
    if route == "cuda":
        return dequantize_cuda(codes, norms, levels)
    if route == "meta":
        return dequantize_meta(codes, norms, levels)
    return ref.dequantize_ref(codes, norms, levels)


def bucket_stats_op(vb: torch.Tensor, *, norm_type: str = NORM_L2
                    ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    route = _route(vb, "bucket_stats")
    if route == "cuda":
        return bucket_stats_cuda(vb, norm_type)
    if route == "meta":
        return bucket_stats_meta(vb, norm_type)
    return ref.bucket_stats_ref(vb, norm_type)
