"""CUDA kernel: fused bucket norm + normalize + stochastic round.

The per-step encode of Algorithm 1 (line 6).  Source:
``csrc/quantize.cu``, which replaces the TPU kernel
``repro/kernels/quantize.py::quantize_pallas``.  The uniforms ``u`` are
an explicit input, so the kernel is a pure function of its inputs.

``quantize_cuda`` launches the kernel.  ``quantize_meta`` is the same
kernel as the operator ``repro_torch::quantize``, whose fake gives the
outputs' shapes and dtypes: ``ops`` calls it for meta tensors only, so
that the dry run (``launch.dryrun``) sees the kernel as the one operator
the card runs, while the card's route pays no custom-op dispatch.
"""
from __future__ import annotations

import torch

from repro_torch.core.quantize import code_dtype
from . import cuda


def _check(vb: torch.Tensor, u: torch.Tensor, levels: torch.Tensor,
           norm_type: str) -> None:
    cuda.check(vb.dim() == 2 and u.shape == vb.shape,
               f"quantize: vb {tuple(vb.shape)} and u {tuple(u.shape)} "
               "must be one (nb, bs) shape")
    cuda.check(vb.dtype in cuda.IN_CODES and u.dtype == torch.float32
               and levels.dtype == torch.float32,
               "quantize: vb f32 or bf16, u and levels f32")
    cuda.check(levels.dim() == 1 and 2 <= levels.shape[0] <= cuda.MAX_LEVELS,
               f"quantize: 2..{cuda.MAX_LEVELS} levels")
    cuda.check(norm_type in cuda.NORM_CODES, f"quantize: norm {norm_type!r}")
    cuda.check(vb.is_contiguous() and u.is_contiguous()
               and levels.is_contiguous(), "quantize: contiguous inputs")


def quantize_cuda(vb: torch.Tensor, u: torch.Tensor, levels: torch.Tensor,
                  norm_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(nb, bs) f32/bf16 values + (nb, bs) f32 uniforms + (L,) f32 levels
    -> (codes (nb, bs) int8, or int16 when L > 128; norms (nb,) f32)."""
    dev = vb.device
    cuda.check(vb.is_cuda and u.device == dev and levels.device == dev,
               "quantize: vb, u and levels must lie on one CUDA device")
    _check(vb, u, levels, norm_type)
    nb, bs = vb.shape
    L = levels.shape[0]
    codes = torch.empty((nb, bs), dtype=code_dtype(L), device=dev)
    norms = torch.empty((nb,), dtype=torch.float32, device=dev)
    ptrs = (vb.data_ptr(), u.data_ptr(), codes.data_ptr())
    launch = cuda.bucket_launch(bs, vb.element_size(), ptrs)
    cuda.launch("quantize", dev, vb.data_ptr(), u.data_ptr(),
                levels.data_ptr(), codes.data_ptr(), norms.data_ptr(), nb,
                bs, L, cuda.IN_CODES[vb.dtype], cuda.CODE_CODES[codes.dtype],
                cuda.NORM_CODES[norm_type], *launch.args(),
                layout=launch.layout)
    return codes, norms


@torch.library.custom_op("repro_torch::quantize", mutates_args=())
def quantize_meta(vb: torch.Tensor, u: torch.Tensor, levels: torch.Tensor,
                  norm_type: str) -> tuple[torch.Tensor, torch.Tensor]:
    """``quantize_cuda`` as one operator; on meta tensors its fake runs."""
    return quantize_cuda(vb, u, levels, norm_type)


@quantize_meta.register_fake
def _(vb, u, levels, norm_type):
    _check(vb, u, levels, norm_type)
    nb, bs = vb.shape
    return (vb.new_empty((nb, bs), dtype=code_dtype(levels.shape[0])),
            vb.new_empty((nb,), dtype=torch.float32))
