"""CUDA kernel: fused sufficient statistics (Algorithm 1, line 4).

One pass per bucket gives the Lq norm and the first two moments of the
normalized magnitudes, which ``core.stats.stats_from_moments`` turns
into the truncated-normal mixture.  Source: ``csrc/bucket_stats.cu``,
which replaces the TPU kernel
``repro/kernels/bucket_stats.py::bucket_stats_pallas``.
``bucket_stats_meta`` is the kernel as the operator
``repro_torch::bucket_stats``, whose fake gives the outputs' shapes and
dtypes to the meta device's dry run (see ``quantize``).
"""
from __future__ import annotations

import torch

from . import cuda


def _check(vb: torch.Tensor, norm_type: str) -> None:
    cuda.check(vb.dim() == 2, f"bucket_stats: vb {tuple(vb.shape)} must be "
               "(nb, bs)")
    cuda.check(vb.dtype in cuda.IN_CODES, "bucket_stats: vb f32 or bf16")
    cuda.check(norm_type in cuda.NORM_CODES,
               f"bucket_stats: norm {norm_type!r}")
    cuda.check(vb.is_contiguous(), "bucket_stats: contiguous input")


def bucket_stats_cuda(vb: torch.Tensor, norm_type: str
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(nb, bs) f32/bf16 values -> per-bucket (norms, mean_r, var_r)."""
    dev = vb.device
    cuda.check(vb.is_cuda, "bucket_stats: vb must lie on a CUDA device")
    _check(vb, norm_type)
    nb, bs = vb.shape
    norms, mu, var = (torch.empty((nb,), dtype=torch.float32, device=dev)
                      for _ in range(3))
    launch = cuda.bucket_launch(bs, vb.element_size(), (vb.data_ptr(),))
    cuda.launch("bucket_stats", dev, vb.data_ptr(), norms.data_ptr(),
                mu.data_ptr(), var.data_ptr(), nb, bs,
                cuda.IN_CODES[vb.dtype], cuda.NORM_CODES[norm_type],
                *launch.args(), layout=launch.layout)
    return norms, mu, var


@torch.library.custom_op("repro_torch::bucket_stats", mutates_args=())
def bucket_stats_meta(vb: torch.Tensor, norm_type: str
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``bucket_stats_cuda`` as one operator; on meta tensors its fake
    runs."""
    return bucket_stats_cuda(vb, norm_type)


@bucket_stats_meta.register_fake
def _(vb, norm_type):
    _check(vb, norm_type)
    nb = vb.shape[0]
    return tuple(vb.new_empty((nb,), dtype=torch.float32) for _ in range(3))
