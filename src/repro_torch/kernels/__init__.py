"""The CUDA kernels of the port, their plain versions and their dispatch.
``quantize_cuda``, ``dequantize_cuda`` and ``bucket_stats_cuda`` stand for
the reference's ``*_pallas`` kernels; ``dequantize_mean_cuda`` fuses the
reference's decode of gathered streams with their average; nothing is
built on import."""
from .ops import (bucket_stats_op, dequantize_mean_op, dequantize_op,
                  quantize_op)
from .quantize import quantize_cuda
from .dequantize import dequantize_cuda, dequantize_mean_cuda
from .bucket_stats import bucket_stats_cuda
