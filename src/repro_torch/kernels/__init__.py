"""The CUDA kernels of the port, their plain versions and their dispatch.
``quantize_cuda``, ``dequantize_cuda`` and ``bucket_stats_cuda`` stand for
the reference's ``*_pallas`` kernels; nothing is built on import."""
from .ops import bucket_stats_op, dequantize_op, quantize_op
from .quantize import quantize_cuda
from .dequantize import dequantize_cuda
from .bucket_stats import bucket_stats_cuda
