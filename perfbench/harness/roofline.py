"""The card's peaks and the least work of the kernels whose roofline
share the benchmark reports.

Peaks are NVIDIA's data-sheet figures for the H100 SXM5 at its full
700 W: 989.4 TFLOP/s of dense bfloat16 tensor-core math and 3.35 TB/s of
HBM3.  The wire's kernels do a few operations a byte, far under the
compute bound, so their least time is their bytes over the bandwidth:
every input byte read once and every output byte written once.  The
attention's is its FLOPs over the bfloat16 peak: the products of the
(query, key) pairs that the causal window admits.
"""
from __future__ import annotations

from typing import NamedTuple


class Peak(NamedTuple):
    bf16_flops: float   # dense, FLOP/s
    hbm_bytes: float    # bytes/s


PEAKS = {"NVIDIA H100 80GB HBM3": Peak(989.4e12, 3.35e12)}
H100 = PEAKS["NVIDIA H100 80GB HBM3"]


def peak_of(kind: str) -> Peak:
    if kind not in PEAKS:
        raise ValueError(f"no peaks known for {kind!r}; known: "
                         f"{sorted(PEAKS)}")
    return PEAKS[kind]


def code_bytes(num_levels: int) -> int:
    """Bytes of one signed level index: int8 up to 128 levels."""
    return 1 if num_levels <= 128 else 2


def quantize_bytes(nb: int, bucket_size: int, num_levels: int,
                   in_bytes: int = 4) -> int:
    """One quantize launch over (nb, bucket_size): the float32 values and
    their float32 uniforms read, the codes and the nb float32 norms
    written (the level table's few bytes left out)."""
    n = nb * bucket_size
    return n * (in_bytes + 4 + code_bytes(num_levels)) + nb * 4


def dequantize_mean_bytes(streams: int, nb: int, bucket_size: int,
                          num_levels: int) -> int:
    """One dequantize_mean launch: M streams of (nb, bucket_size) codes
    and their nb norms read, the level table read, nb x bucket_size
    float32 written."""
    n = nb * bucket_size
    return (streams * (n * code_bytes(num_levels) + nb * 4)
            + num_levels * 4 + n * 4)


def bound_s(nbytes: int, peak: Peak = H100) -> float:
    return nbytes / peak.hbm_bytes


def attention_pairs(S: int, window: int = 0) -> int:
    """The (query, key) pairs of a sequence of S that the causal window
    admits: query t sees the keys t - window < s <= t (every s <= t where
    ``window`` is 0)."""
    w = S if window <= 0 else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def attention_flops(B: int, S: int, H: int, hd: int, window: int = 0
                    ) -> tuple[int, int]:
    """(forward, backward) FLOPs of the attention of B rows of S over H
    query heads of ``hd``: each admitted pair is a product of 2 hd FLOPs
    in q k^T, p v (the forward) and in the backward's dv, dp, dq and dk."""
    pair = B * H * attention_pairs(S, window) * 2 * hd
    return 2 * pair, 4 * pair


def flops_bound_s(flops: float, peak: Peak = H100) -> float:
    return flops / peak.bf16_flops
