"""CUDA kernel: decode signed level indices (DECODE_l, Algorithm 1 line 8).

Source: ``csrc/dequantize.cu``, which replaces the TPU kernel
``repro/kernels/dequantize.py::dequantize_pallas``.  ``dequantize_meta``
is the kernel as the operator ``repro_torch::dequantize``, whose fake
gives the output's shape and dtype to the meta device's dry run (see
``quantize``).
"""
from __future__ import annotations

import torch

from . import cuda


def _check(codes: torch.Tensor, norms: torch.Tensor,
           levels: torch.Tensor) -> None:
    cuda.check(codes.dim() == 2 and norms.shape == codes.shape[:1],
               f"dequantize: codes {tuple(codes.shape)} need (nb,) norms, "
               f"got {tuple(norms.shape)}")
    cuda.check(codes.dtype in cuda.CODE_CODES and norms.dtype == torch.float32
               and levels.dtype == torch.float32,
               "dequantize: int8/int16/int32 codes, f32 norms and levels")
    cuda.check(levels.dim() == 1 and 1 <= levels.shape[0] <= cuda.MAX_LEVELS,
               f"dequantize: 1..{cuda.MAX_LEVELS} levels")
    cuda.check(codes.is_contiguous() and norms.is_contiguous()
               and levels.is_contiguous(), "dequantize: contiguous inputs")


def dequantize_cuda(codes: torch.Tensor, norms: torch.Tensor,
                    levels: torch.Tensor) -> torch.Tensor:
    """(nb, bs) int8/int16/int32 codes + (nb,) f32 norms + (L,) f32 levels
    -> (nb, bs) f32 values ``levels[|c|] * sign(c) * norm``."""
    dev = codes.device
    cuda.check(codes.is_cuda and norms.device == dev and levels.device == dev,
               "dequantize: codes, norms and levels must lie on one CUDA "
               "device")
    _check(codes, norms, levels)
    nb, bs = codes.shape
    out = torch.empty((nb, bs), dtype=torch.float32, device=dev)
    cuda.launch("dequantize", dev, codes.data_ptr(), norms.data_ptr(),
                levels.data_ptr(), out.data_ptr(), nb, bs, levels.shape[0],
                cuda.CODE_CODES[codes.dtype], cuda.block_threads(bs))
    return out


@torch.library.custom_op("repro_torch::dequantize", mutates_args=())
def dequantize_meta(codes: torch.Tensor, norms: torch.Tensor,
                    levels: torch.Tensor) -> torch.Tensor:
    """``dequantize_cuda`` as one operator; on meta tensors its fake runs."""
    return dequantize_cuda(codes, norms, levels)


@dequantize_meta.register_fake
def _(codes, norms, levels):
    _check(codes, norms, levels)
    return codes.new_empty(codes.shape, dtype=torch.float32)
