"""CUDA kernels: decode signed level indices (DECODE_l, Algorithm 1 line
8), and the decode of M gathered streams fused with their average.

Source: ``csrc/dequantize.cu``.  ``dequantize`` replaces the TPU kernel
``repro/kernels/dequantize.py::dequantize_pallas``; ``dequantize_mean``
replaces none: it is the reference's decode of the gathered streams and
its transport's ``mean_workers`` in one pass, which XLA fuses and a
kernel launch cannot, so that the wire's decode holds no (M, n) float32.
``dequantize_meta`` and ``dequantize_mean_meta`` are the kernels as the
operators ``repro_torch::dequantize`` and ``repro_torch::dequantize_mean``,
whose fakes give the outputs' shapes and dtypes to the meta device's dry
run (see ``quantize``).
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
                cuda.CODE_CODES[codes.dtype], cuda.STREAM_THREADS)
    return out


def _check_mean(codes: torch.Tensor, norms: torch.Tensor,
                levels: torch.Tensor, weights: torch.Tensor | None,
                valid: torch.Tensor | None) -> None:
    cuda.check(codes.dim() == 3 and norms.shape == codes.shape[:2],
               f"dequantize_mean: codes {tuple(codes.shape)} need (M, nb) "
               f"norms, got {tuple(norms.shape)}")
    _check(codes[0], norms[0], levels)
    cuda.check(codes.is_contiguous() and norms.is_contiguous(),
               "dequantize_mean: contiguous inputs")
    M, nb = norms.shape
    if weights is not None:
        cuda.check(weights.dtype == torch.float32
                   and weights.shape in ((M,), (M, nb)),
                   f"dequantize_mean: f32 weights of ({M},) or ({M}, {nb})")
    if valid is not None:
        cuda.check(weights is not None, "dequantize_mean: validity needs "
                   "weights")
        cuda.check(valid.dtype == torch.bool and valid.shape == (M, nb)
                   and valid.is_contiguous(),
                   f"dequantize_mean: a contiguous ({M}, {nb}) bool validity")


def dequantize_mean_cuda(codes: torch.Tensor, norms: torch.Tensor,
                         levels: torch.Tensor,
                         weights: torch.Tensor | None = None,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """(M, nb, bs) codes + (M, nb) norms + (L,) levels -> (nb, bs) f32: the
    streams' values averaged in worker order, as ``ref.dequantize_mean_ref``
    (the plain mean without ``weights``; the weighted sum with (M,) or (M,
    nb) weights; invalid buckets as 0 with an (M, nb) ``valid``)."""
    dev = codes.device
    cuda.check(codes.is_cuda and all(
        t.device == dev for t in (norms, levels, weights, valid)
        if t is not None),
        "dequantize_mean: every input must lie on one CUDA device")
    _check_mean(codes, norms, levels, weights, valid)
    M, nb, bs = codes.shape
    if weights is not None:
        if weights.dim() == 1:
            weights = weights[:, None].expand(M, nb)
        weights = weights.contiguous()
    out = torch.empty((nb, bs), dtype=torch.float32, device=dev)
    cuda.launch("dequantize_mean", dev, codes.data_ptr(), norms.data_ptr(),
                levels.data_ptr(),
                None if weights is None else weights.data_ptr(),
                None if valid is None else valid.data_ptr(), out.data_ptr(),
                M, nb, bs, levels.shape[0], cuda.CODE_CODES[codes.dtype],
                cuda.STREAM_THREADS)
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


@torch.library.custom_op("repro_torch::dequantize_mean", mutates_args=())
def dequantize_mean_meta(codes: torch.Tensor, norms: torch.Tensor,
                         levels: torch.Tensor,
                         weights: torch.Tensor | None = None,
                         valid: torch.Tensor | None = None) -> torch.Tensor:
    """``dequantize_mean_cuda`` as one operator; on meta tensors its fake
    runs."""
    return dequantize_mean_cuda(codes, norms, levels, weights, valid)


@dequantize_mean_meta.register_fake
def _(codes, norms, levels, weights=None, valid=None):
    _check_mean(codes, norms, levels, weights, valid)
    return codes.new_empty(codes.shape[1:], dtype=torch.float32)
