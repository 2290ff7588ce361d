"""GradientCodec: the ENCODE -> pack -> wire layer.

A codec owns three things:

``plan(d)``   The static wire layout of a ``d``-coordinate gradient: the
              padded bucket count, the packed-word counts and the exact
              bits/coordinate.
``encode``    (nb, bucket_size) values + levels -> ``WirePayload``: packed
              level symbols and packed bucket norms, 32-bit words carried
              as int32 bit patterns (``core.packing``).
``decode``    The inverse over one stream or over M gathered streams at
              once -> (n,) or (M, n) values.

This module holds ``UniformCodec``, the paper's wire format: one global
(bits, bucket_size).  Its payloads are bit-identical with the reference
package's for the same inputs and uniforms.  Integrity words and sharded
payloads (the two_phase mode) are not part of this port yet: a payload
is one segment holding every bucket.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.timing import NO_CLOCK
from . import packing
from .quantize import pad_to_buckets

# The bucket count is padded to a multiple of this, as in the reference
# (whose Pallas grid tiles 8 buckets), so that plans and payload shapes
# match it; the CUDA kernels themselves take any bucket count.
DEFAULT_BUCKET_TILE = 8


class WirePayload(NamedTuple):
    """What travels: packed level symbols + packed bucket norms (int32
    bit patterns).  One stream is 1-D; gathered streams carry a leading
    worker axis."""

    words: torch.Tensor
    norm_words: torch.Tensor


class WirePlan(NamedTuple):
    """Static layout of one tensor's wire payload."""

    d: int                 # original (unpadded) coordinate count
    bucket_size: int
    nb: int                # padded bucket count (tile aligned)
    code_words: int        # 32-bit words of packed symbols
    norm_words: int        # 32-bit words of packed norms
    bits_per_coord: float  # shipped wire bits (codes+norms) per coord

    @property
    def n(self) -> int:
        return self.nb * self.bucket_size


def _align_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class GradientCodec:
    """Base codec: bucketing + norm side-channel; subclasses own the
    symbol layout."""

    bucket_size: int = 8192
    norm_type: str = "l2"
    norm_dtype: str = "float32"

    def plan(self, d: int) -> WirePlan:
        """Layout for a ``d``-coordinate tensor."""
        nb = _align_up(-(-d // self.bucket_size), DEFAULT_BUCKET_TILE)
        return self.plan_buckets(nb, d=d)

    def plan_buckets(self, nb: int, *, d: int | None = None) -> WirePlan:
        """Layout for an exact (already aligned) bucket count."""
        raise NotImplementedError

    def bucketize(self, flat: torch.Tensor, plan: WirePlan) -> torch.Tensor:
        """(d,) -> (nb, bucket_size) zero-padded to the plan's layout.

        Zero buckets are exact fixed points of ENCODE/DECODE (norm 0,
        code 0), so padding never leaks into aggregates.
        """
        vb = pad_to_buckets(flat.reshape(-1), self.bucket_size)
        if plan.nb != vb.shape[0]:
            vb = torch.cat([vb, vb.new_zeros(plan.nb - vb.shape[0],
                                             self.bucket_size)])
        return vb


@dataclasses.dataclass(frozen=True)
class UniformCodec(GradientCodec):
    """One (num_levels, bucket_size) for every bucket.

    Encode is one fused quantize kernel and one fixed-width pack; decode
    is one unpack per stream and one fused dequantize over all streams.
    """

    num_levels: int = 8

    def plan_buckets(self, nb: int, *, d: int | None = None) -> WirePlan:
        if d is None:
            d = nb * self.bucket_size
        cw = packing.packed_words(nb * self.bucket_size,
                                  packing.wire_bits_for(self.num_levels))
        nw = packing.norm_words(nb, self.norm_dtype)
        return WirePlan(d=d, bucket_size=self.bucket_size, nb=nb,
                        code_words=cw, norm_words=nw,
                        bits_per_coord=32.0 * (cw + nw) / d)

    def encode(self, vb: torch.Tensor, levels: torch.Tensor, *,
               u: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               clock=NO_CLOCK) -> WirePayload:
        """(nb, bucket_size) -> packed payload.

        ``u`` are the (nb, bucket_size) float32 uniforms of the stochastic
        rounding; when it is None they are drawn from ``generator``.
        """
        if u is None:
            u = torch.rand(vb.shape, generator=generator,
                           dtype=torch.float32, device=vb.device)
        codes, norms = ops.quantize_op(vb, u, levels,
                                       norm_type=self.norm_type)
        del u
        clock.mark("encode")
        payload = WirePayload(
            words=packing.pack_signed(codes, levels.shape[0]),
            norm_words=packing.pack_norms(norms, self.norm_dtype))
        clock.mark("pack")
        return payload

    def decode(self, payload: WirePayload, levels: torch.Tensor,
               plan: WirePlan, *, clock=NO_CLOCK) -> torch.Tensor:
        """Payload stream(s) -> values: a 1-D payload decodes to (n,),
        gathered (M, ...) streams to (M, n) in one dequantize call."""
        words, nwords = payload
        single = words.dim() == 1
        if single:
            words, nwords = words[None], nwords[None]
        M = words.shape[0]
        L = levels.shape[0]
        norms = torch.stack([packing.unpack_norms(w, plan.nb, self.norm_dtype)
                             for w in nwords])
        sym = torch.empty((M, plan.n), dtype=torch.int32, device=words.device)
        for m in range(M):
            sym[m] = packing.unpack_signed(words[m], plan.n, L)
        clock.mark("unpack")
        vals = ops.dequantize_op(sym.reshape(M * plan.nb, self.bucket_size),
                                 norms.reshape(-1), levels)
        del sym
        vals = vals.reshape(M, plan.n)
        clock.mark("decode")
        return vals[0] if single else vals


def codec_for_scheme(scheme) -> UniformCodec:
    """The production codec of a ``QuantScheme``: its global width."""
    return UniformCodec(num_levels=scheme.num_levels,
                        bucket_size=scheme.bucket_size,
                        norm_type=scheme.norm_type,
                        norm_dtype=scheme.norm_dtype)
