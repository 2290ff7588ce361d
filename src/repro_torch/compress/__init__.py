"""repro_torch.compress: stateful gradient-compression algorithms.

Layering (outermost first):

    CompressionAlgorithm   residual state + warmup gate   (this package)
    GradientCodec          wire layout: dense / sparse payloads
    transport              collectives that move the packed words

Selection is a spec string (``TrainConfig(compress=...)``, the
``--compress`` flag):

    "plain"      stateless passthrough (bit-exact with the raw codec path)
    "ef"         error feedback;          "ef:<warmup_steps>"
    "topk"       EF + SparseCodec at the scheme's equal-wire-budget k;
                 "topk:<k>" for an explicit kept count per bucket
"""
from __future__ import annotations

from .base import CompressionAlgorithm, CompressState, EFAlgorithm
from .sparse import SparseCodec, sparse_codec_for_scheme

ALGORITHMS = ("plain", "ef", "topk")

__all__ = [
    "ALGORITHMS",
    "CompressState",
    "CompressionAlgorithm",
    "EFAlgorithm",
    "SparseCodec",
    "make_algorithm",
    "sparse_codec_for_scheme",
]


def make_algorithm(spec: str, scheme, codec=None) -> CompressionAlgorithm:
    """Build an algorithm from its spec string.

    ``codec`` is the dense wire codec ``plain`` and ``ef`` drive (None:
    the scheme's uniform codec).  ``topk`` builds its own ``SparseCodec``,
    so an explicit ``codec`` with ``topk`` is a configuration conflict and
    raises rather than silently dropping one of the two.
    """
    from repro_torch.core.codec import codec_for_scheme

    name, _, arg = str(spec).partition(":")
    if name == "topk":
        if codec is not None:
            raise ValueError(
                "compress='topk' builds its own SparseCodec and cannot "
                f"compose with an explicit codec ({type(codec).__name__}"
                "); configure either the codec or top-k sparsification, "
                "not both")
        sparse = sparse_codec_for_scheme(scheme, k=int(arg) if arg else None)
        return EFAlgorithm(codec=sparse, name="topk")
    if codec is None:
        codec = codec_for_scheme(scheme)
    if name == "plain":
        return CompressionAlgorithm(codec=codec)
    if name == "ef":
        return EFAlgorithm(codec=codec, warmup_steps=int(arg) if arg else 0)
    raise ValueError(
        f"unknown compression algorithm {name!r}; known: {ALGORITHMS}")
