"""GradientCodec: the ENCODE -> pack -> wire layer.

A codec owns three things:

``plan(d)``   The static wire layout of a ``d``-coordinate gradient: the
              padded bucket count, the packed-word counts per segment and
              the exact bits/coordinate.
``encode``    (nb, bucket_size) values + levels -> ``WirePayload``: packed
              level symbols and packed bucket norms, 32-bit words carried
              as int32 bit patterns (``core.packing``).
``decode``    The inverse over one stream or over M gathered streams at
              once -> (n,) or (M, n) values.

This module holds ``UniformCodec``, the paper's wire format: one global
(bits, bucket_size).  Its payloads are bit-identical with the reference
package's for the same inputs and uniforms.

Sharded plans (``shards=M``) split a payload per destination worker (the
two_phase reduce-scatter): segment ``s`` holds buckets ``[s*shard_nb,
(s+1)*shard_nb)``, and a sharded payload carries a leading segment axis.
Integrity plans (``integrity=True``) lay one checksum word per bucket
(``packing.bucket_checksums``) before each segment's symbols;
``decode_checked`` returns a per-stream, per-bucket validity mask beside
the values.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from repro_torch.kernels import ops
from repro_torch.timing import NO_CLOCK
from . import packing
from .levels import num_levels as _num_levels_for_bits
from .quantize import NORM_LINF, pad_to_buckets

# The bucket count is padded to a multiple of this, as in the reference
# (whose Pallas grid tiles 8 buckets), so that plans and payload shapes
# match it; the CUDA kernels themselves take any bucket count.
DEFAULT_BUCKET_TILE = 8


class WirePayload(NamedTuple):
    """What travels: packed level symbols + packed bucket norms (int32
    bit patterns).  One unsharded stream is 1-D; a sharded payload
    carries a leading segment axis, gathered streams a leading worker
    axis."""

    words: torch.Tensor
    norm_words: torch.Tensor


class WirePlan(NamedTuple):
    """Static layout of one tensor's wire payload."""

    d: int                 # original (unpadded) coordinate count
    bucket_size: int
    nb: int                # padded bucket count (tile and shard aligned)
    shards: int            # payload segments (1 = whole tensor)
    code_words: int        # 32-bit words of symbols (+ checksums) a segment
    norm_words: int        # 32-bit words of packed norms a segment
    bits_per_coord: float  # shipped wire bits (codes+norms) per coord
    integrity: bool = False  # one checksum word per bucket in the payload

    @property
    def n(self) -> int:
        return self.nb * self.bucket_size

    @property
    def shard_nb(self) -> int:
        return self.nb // self.shards

    @property
    def shard_n(self) -> int:
        return self.shard_nb * self.bucket_size


def _align_up(x: int, m: int) -> int:
    return -(-x // m) * m


@dataclasses.dataclass(frozen=True)
class GradientCodec:
    """Base codec: bucketing + norm side-channel; subclasses own the
    symbol layout."""

    bucket_size: int = 8192
    norm_type: str = "l2"
    norm_dtype: str = "float32"
    # one checksum word per bucket in the payload, and ``decode_checked``
    integrity: bool = False

    def plan(self, d: int, *, shards: int = 1) -> WirePlan:
        """Layout for a ``d``-coordinate tensor split into ``shards``
        segments; the bucket count is padded to ``shards * tile``."""
        nb = _align_up(-(-d // self.bucket_size),
                       shards * DEFAULT_BUCKET_TILE)
        return self.plan_buckets(nb, shards=shards, d=d)

    def plan_buckets(self, nb: int, *, shards: int = 1,
                     d: int | None = None) -> WirePlan:
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

    def decode(self, payload: WirePayload, levels: torch.Tensor,
               plan: WirePlan, *, shard=None, clock=NO_CLOCK
               ) -> torch.Tensor:
        """Payload stream(s) -> values: a 1-D payload decodes to
        (shard_n,), gathered (M, ...) streams to (M, shard_n).  Every
        segment of the port's codecs has one layout, so ``shard`` (the
        segment the streams carry; None: stream i carries segment i)
        only names what is decoded."""
        raise NotImplementedError


def rounding_uniforms(shape, device, u, generator) -> torch.Tensor:
    """The given uniforms ``u``, or a float32 draw from ``generator``."""
    if u is not None:
        return u
    return torch.rand(shape, generator=generator, dtype=torch.float32,
                      device=device)


@dataclasses.dataclass(frozen=True)
class UniformCodec(GradientCodec):
    """One (num_levels, bucket_size) for every bucket.

    Encode is one fused quantize kernel and one fixed-width pack per
    segment; decode is one unpack per stream and one fused dequantize
    over all streams.
    """

    num_levels: int = 8

    def plan_buckets(self, nb: int, *, shards: int = 1,
                     d: int | None = None) -> WirePlan:
        if nb % shards:
            raise ValueError(f"nb={nb} not divisible by shards={shards}")
        if d is None:
            d = nb * self.bucket_size
        snb = nb // shards
        cw = packing.packed_words(snb * self.bucket_size,
                                  packing.wire_bits_for(self.num_levels))
        if self.integrity:
            cw += snb                     # per-bucket checksum words
        nw = packing.norm_words(snb, self.norm_dtype)
        return WirePlan(d=d, bucket_size=self.bucket_size, nb=nb,
                        shards=shards, code_words=cw, norm_words=nw,
                        bits_per_coord=32.0 * shards * (cw + nw) / d,
                        integrity=self.integrity)

    def _checksums(self, codes: torch.Tensor, norms: torch.Tensor,
                   L: int) -> torch.Tensor:
        """Integrity words of signed ``codes`` over ``L`` levels, biased a
        row chunk at a time so that no int32 copy of the whole stream is
        made."""
        nbits = packing.norm_bit_patterns(norms, self.norm_dtype)
        rows = max(1, packing.CHUNK_SYMBOLS // self.bucket_size)
        return torch.cat([
            packing.bucket_checksums(packing.bias_codes(codes[r:r + rows], L),
                                     nbits[r:r + rows])
            for r in range(0, codes.shape[0], rows)])

    def encode(self, vb: torch.Tensor, levels: torch.Tensor, *,
               plan: WirePlan | None = None,
               u: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               clock=NO_CLOCK) -> WirePayload:
        """(nb, bucket_size) -> packed payload, segmented per ``plan``
        (default: one segment of every bucket).

        ``u`` are the (nb, bucket_size) float32 uniforms of the stochastic
        rounding; when it is None they are drawn from ``generator``.
        """
        if plan is None:
            plan = self.plan_buckets(vb.shape[0])
        u = rounding_uniforms(vb.shape, vb.device, u, generator)
        codes, norms = ops.quantize_op(vb, u, levels,
                                       norm_type=self.norm_type)
        del u
        clock.mark("encode")
        L = levels.shape[0]
        snb = plan.shard_nb
        csum = None
        if self.integrity:
            csum = self._checksums(codes, norms, L)
            clock.mark("checksum")

        def seg_words(j):
            w = packing.pack_signed(codes[j * snb:(j + 1) * snb], L)
            if csum is not None:
                w = torch.cat([csum[j * snb:(j + 1) * snb], w])
            return w

        words = torch.stack([seg_words(j) for j in range(plan.shards)])
        nwords = torch.stack([
            packing.pack_norms(norms[j * snb:(j + 1) * snb], self.norm_dtype)
            for j in range(plan.shards)])
        clock.mark("pack")
        if plan.shards == 1:
            return WirePayload(words=words[0], norm_words=nwords[0])
        return WirePayload(words=words, norm_words=nwords)

    def _decode_uniform(self, payload, levels, plan, want_valid, clock):
        words, nwords = payload
        single = words.dim() == 1
        if single:
            words, nwords = words[None], nwords[None]
        snb, n, bs = plan.shard_nb, plan.shard_n, self.bucket_size
        M = words.shape[0]
        L = levels.shape[0]
        wb = packing.wire_bits_for(L)
        stored = None
        if plan.integrity:
            stored, words = words[:, :snb], words[:, snb:]
        norms = torch.stack([packing.unpack_norms(w, snb, self.norm_dtype)
                             for w in nwords])
        sym = torch.empty((M, n), dtype=torch.int32, device=words.device)
        valid = None
        if want_valid:
            valid = torch.ones((M, snb), dtype=torch.bool,
                               device=words.device)
        for m in range(M):
            sym[m] = packing.unpack(words[m], n, wb)
            if want_valid and stored is not None:
                clock.mark("unpack")
                valid[m] = packing.bucket_checksums(
                    sym[m].view(snb, bs),
                    packing.norm_bit_patterns(norms[m], self.norm_dtype)
                ) == stored[m]
                clock.mark("checksum")
        sym -= L - 1                      # unsigned symbols -> signed codes
        clock.mark("unpack")
        vals = ops.dequantize_op(sym.view(M * snb, bs), norms.reshape(-1),
                                 levels)
        del sym
        vals = vals.view(M, n)
        clock.mark("decode")
        if single:
            return vals[0], None if valid is None else valid[0]
        return vals, valid

    def decode(self, payload, levels, plan, *, shard=None, clock=NO_CLOCK):
        return self._decode_uniform(payload, levels, plan, False, clock)[0]

    def decode_checked(self, payload, levels, plan, *, shard=None,
                       clock=NO_CLOCK):
        """``decode`` plus a bool validity verdict per stream and bucket,
        (shard_nb,) or (M, shard_nb): True iff the bucket's checksum word
        matches its symbols and norm bits (always, without an integrity
        plan)."""
        return self._decode_uniform(payload, levels, plan, True, clock)

    def requantize(self, vb: torch.Tensor, levels: torch.Tensor, *,
                   u: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """Value-space wire round trip Q(vb) of (nb, bucket_size) values:
        norms take the packed wire round trip, so values match the wire's
        bytes."""
        u = rounding_uniforms(vb.shape, vb.device, u, generator)
        codes, norms = ops.quantize_op(vb, u, levels,
                                       norm_type=self.norm_type)
        wn = packing.unpack_norms(packing.pack_norms(norms, self.norm_dtype),
                                  norms.shape[0], self.norm_dtype)
        return ops.dequantize_op(codes, wn, levels)


def codec_for_scheme(scheme) -> UniformCodec:
    """The production codec of a ``QuantScheme``: its global width."""
    return UniformCodec(num_levels=scheme.num_levels,
                        bucket_size=scheme.bucket_size,
                        norm_type=scheme.norm_type,
                        norm_dtype=scheme.norm_dtype)


def requant_codec(codec: GradientCodec, bits: int) -> UniformCodec:
    """The fixed re-quantization grid over a base codec: uniform
    ``bits``-bit levels under L-inf bucket norms, with the base's
    bucketing, norm side-channel and integrity.  The two_phase broadcast
    hop uses it."""
    return UniformCodec(num_levels=_num_levels_for_bits(bits),
                        bucket_size=codec.bucket_size,
                        norm_type=NORM_LINF,
                        norm_dtype=codec.norm_dtype,
                        integrity=codec.integrity)


def make_codec(scheme, kind: str = "uniform", *,
               integrity: bool = False) -> UniformCodec:
    """The codec a ``TrainConfig`` selects.  The port has the ``uniform``
    kind; the entropy-coded and mixed-width kinds are not ported."""
    if kind != "uniform":
        raise ValueError(f"codec kind {kind!r} is not ported; known: "
                         "('uniform',)")
    codec = codec_for_scheme(scheme)
    if integrity:
        codec = dataclasses.replace(codec, integrity=True)
    return codec
