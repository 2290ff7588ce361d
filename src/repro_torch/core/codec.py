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
``decode_mean`` M gathered streams -> their mean under a transport's
              averaging rule, (n,), with each stream's own values on
              request; the uniform, entropy and mixed-width codecs decode
              and average in one fused kernel (``dequantize_mean``), so
              that no (M, n) float32 is held.

Three codecs ship here (plus ``repro_torch.compress.SparseCodec``), each
bit-identical on the wire with the reference package's for the same
inputs and uniforms:

``UniformCodec``     one global (bits, bucket_size): the paper's wire.
``EntropyCodec``     the uniform symbol stream coded per bucket with a
    static canonical-Huffman table; the payload keeps the worst-case
    capacity layout, and the measured volume is read off per-bucket
    length headers (``WirePlan.variable``).
``MixedWidthCodec``  per-bucket wire widths inside one tensor, each width
    group on the base grid resampled to its resolution
    (``resample_levels``); ``assign_mixed_widths`` chooses the widths
    from per-bucket statistics under a mean-bits budget.

Sharded plans (``shards=M``) split a payload per destination worker (the
two_phase reduce-scatter): segment ``s`` holds buckets ``[s*shard_nb,
(s+1)*shard_nb)``, and a sharded payload carries a leading segment axis.
Uniform and entropy segments share one layout; mixed-width segments each
have their own width groups, padded to the largest segment's word count.
Integrity plans (``integrity=True``, uniform and entropy only) lay one
checksum word per bucket (``packing.bucket_checksums``) before each
segment's symbols; ``decode_checked`` returns a per-stream, per-bucket
validity mask beside the values.
"""
from __future__ import annotations

import dataclasses
import functools
import heapq
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.timing import NO_CLOCK
from . import packing
from .levels import num_levels as _num_levels_for_bits
from .quantize import NORM_LINF, code_dtype, pad_to_buckets

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
    widths: tuple | None = None  # per-bucket scheme bits (mixed width)
    # the payload is the worst-case capacity and the bytes that need to
    # travel are data-dependent: ``codec.measured_bits_per_coord``
    variable: bool = False

    @property
    def n(self) -> int:
        return self.nb * self.bucket_size

    @property
    def shard_nb(self) -> int:
        return self.nb // self.shards

    @property
    def shard_n(self) -> int:
        return self.shard_nb * self.bucket_size

    @property
    def payload_bytes(self) -> float:
        """Bytes of one (padded) segment payload."""
        return 4.0 * (self.code_words + self.norm_words)


class MeanDecode(NamedTuple):
    """What ``decode_mean`` gives: the transport's mean over the M
    streams, (shard_n,); the (M, shard_nb) validity of a checked decode
    (None otherwise); and ``row(w)``, stream w's own decoded values
    (shard_n,), one stream at a time."""

    mean: torch.Tensor
    valid: torch.Tensor | None
    row: Callable[[int], torch.Tensor]


def _align_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _resample_positions(L: int, num_out: int) -> np.ndarray:
    """``num_out`` evenly spaced float32 positions on [0, L-1]."""
    div = num_out - 1
    step = np.float32(L - 1) * (np.float32(1) / np.float32(div))
    return np.append(np.arange(div, dtype=np.float32) * step,
                     np.float32(L - 1))


def resample_levels(levels: torch.Tensor, num_out: int) -> torch.Tensor:
    """Re-grid a level vector to ``num_out`` points on [0, 1].

    Linear interpolation in level-index space at ``num_out`` evenly spaced
    positions, so a mixed-width codec inherits the adaptive grid's shape
    at every width.  Equal to the reference's ``jnp.interp`` over
    ``jnp.linspace`` bit for bit: its compiler evaluates position ``i`` as
    ``i * ((L-1) * (1/(num_out-1)))`` in float32 and the interpolation
    ``lo + delta * (hi - lo)`` as one fused multiply-add.  Float64 holds
    that product exactly, so only a float64 sum lying exactly on a float32
    rounding midpoint could round otherwise.
    """
    L = levels.shape[0]
    if num_out == L:
        return levels
    x = torch.from_numpy(_resample_positions(L, num_out)).to(levels.device)
    i = torch.clamp(x.to(torch.int64) + 1, 1, L - 1)
    lv = levels.to(torch.float32)
    lo = lv[i - 1]
    delta = x - (i - 1).to(torch.float32)
    return (lo.double() + delta.double() * (lv[i] - lo).double()).float()


@dataclasses.dataclass(frozen=True)
class GradientCodec:
    """Base codec: bucketing + norm side-channel; subclasses own the
    symbol layout."""

    bucket_size: int = 8192
    norm_type: str = "l2"
    norm_dtype: str = "float32"
    # one checksum word per bucket in the payload, and ``decode_checked``
    integrity: bool = False

    @property
    def chunkable(self) -> bool:
        """Whether payloads may be re-planned over any bucket sub-range;
        mixed-width layouts are planned per whole shard and are not."""
        return True

    @property
    def _norm_bits_per_coord(self) -> float:
        return (32.0 if self.norm_dtype == "float32" else
                16.0) / self.bucket_size

    @property
    def nominal_bits_per_coord(self) -> float:
        """Asymptotic wire bits per coordinate (symbols + norms), without
        word-alignment slop, for cost reporting without a plan."""
        raise NotImplementedError

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

    def rounding_shape(self, nb: int) -> tuple[int, int]:
        """Shape of the uniforms that ``encode`` and ``requantize`` take
        for ``nb`` buckets: one a coordinate."""
        return (nb, self.bucket_size)

    def decode(self, payload: WirePayload, levels: torch.Tensor,
               plan: WirePlan, *, shard=None, clock=NO_CLOCK
               ) -> torch.Tensor:
        """Payload stream(s) -> values: a 1-D payload decodes to
        (shard_n,), gathered (M, ...) streams to (M, shard_n).  For a
        sharded plan ``shard`` names the segment the streams carry: an
        int, or None meaning stream i carries segment i (one's own
        sharded payload).  Uniform and entropy segments share one layout
        and ignore it; mixed-width segments each have their own."""
        raise NotImplementedError

    def decode_mean(self, payload: WirePayload, levels: torch.Tensor,
                    plan: WirePlan, transport, *, shard=None,
                    checked: bool = False, clock=NO_CLOCK) -> MeanDecode:
        """Gathered (M, ...) streams -> ``MeanDecode``: their mean under
        ``transport``'s averaging rule (``mean_workers``, or with
        ``checked`` ``decode_checked``'s validity and
        ``mean_workers_bucketed``).  This default decodes every stream and
        then averages, holding the (M, shard_n) values; the uniform,
        entropy and mixed-width codecs fuse the two."""
        if checked:
            vals, valid = self.decode_checked(payload, levels, plan,
                                              shard=shard, clock=clock)
            mean = transport.mean_workers_bucketed(vals, valid,
                                                   self.bucket_size)
        else:
            vals, valid = self.decode(payload, levels, plan, shard=shard,
                                      clock=clock), None
            mean = transport.mean_workers(vals)
        return MeanDecode(mean, valid, lambda w: vals[w])

    def _payload(self, words: torch.Tensor, norms: torch.Tensor,
                 plan: WirePlan) -> WirePayload:
        """(shards, code_words) symbol words + (nb,) norms -> a payload:
        norms packed per segment; an unsharded payload is 1-D."""
        snb = plan.shard_nb
        nwords = torch.stack([
            packing.pack_norms(norms[j * snb:(j + 1) * snb], self.norm_dtype)
            for j in range(plan.shards)])
        if plan.shards == 1:
            return WirePayload(words=words[0], norm_words=nwords[0])
        return WirePayload(words=words, norm_words=nwords)

    def _norm_rows(self, nwords: torch.Tensor, snb: int) -> torch.Tensor:
        """(M, norm_words) packed norms -> (M, snb) float32 norms."""
        return torch.stack([packing.unpack_norms(w, snb, self.norm_dtype)
                            for w in nwords])

    def _wire_norms(self, norms: torch.Tensor) -> torch.Tensor:
        """Norms after the packed wire round trip (fp16 norms round)."""
        return packing.unpack_norms(packing.pack_norms(norms, self.norm_dtype),
                                    norms.shape[0], self.norm_dtype)

    def measured_bits_per_coord(self, payload: WirePayload,
                                plan: WirePlan) -> float:
        """Wire bits per original coordinate that ``payload`` (one
        worker's own encode, 1-D or sharded) needs to ship.  A fixed
        layout ships its plan; variable-volume codecs read the coded
        lengths out of the payload."""
        del payload
        return plan.bits_per_coord


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
    segment; decode is one unpack per stream, into signed codes of
    ``code_dtype(L)``, and one dequantize over all streams, or for
    ``decode_mean`` one ``dequantize_mean`` that averages them as it
    decodes.
    """

    num_levels: int = 8

    @property
    def nominal_bits_per_coord(self) -> float:
        return (packing.wire_bits_for(self.num_levels)
                + self._norm_bits_per_coord)

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
        payload = self._payload(words, norms, plan)
        clock.mark("pack")
        return payload

    def _codes(self, payload, levels, plan, want_valid, clock):
        """Payload stream(s) -> (codes (M, shard_nb, bucket_size) of
        ``code_dtype(L)``, norms (M, shard_nb), validity (M, shard_nb) or
        None, whether the payload was one 1-D stream)."""
        words, nwords = payload
        single = words.dim() == 1
        if single:
            words, nwords = words[None], nwords[None]
        snb, n, bs = plan.shard_nb, plan.shard_n, self.bucket_size
        M = words.shape[0]
        L = levels.shape[0]
        stored = None
        if plan.integrity:
            stored, words = words[:, :snb], words[:, snb:]
        norms = self._norm_rows(nwords, snb)
        codes = torch.empty((M, snb, bs), dtype=code_dtype(L),
                            device=words.device)
        valid = None
        if want_valid:
            valid = torch.ones((M, snb), dtype=torch.bool,
                               device=words.device)
        for m in range(M):
            packing.unpack_signed(words[m], n, L, out=codes[m])
            if want_valid and stored is not None:
                clock.mark("unpack")
                valid[m] = self._checksums(codes[m], norms[m], L) == stored[m]
                clock.mark("checksum")
        clock.mark("unpack")
        return codes, norms, valid, single

    def _decode(self, payload, levels, plan, want_valid, clock):
        codes, norms, valid, single = self._codes(payload, levels, plan,
                                                  want_valid, clock)
        M, snb, bs = codes.shape
        vals = ops.dequantize_op(codes.view(M * snb, bs), norms.reshape(-1),
                                 levels)
        del codes
        vals = vals.view(M, snb * bs)
        clock.mark("decode")
        if single:
            return vals[0], None if valid is None else valid[0]
        return vals, valid

    def decode(self, payload, levels, plan, *, shard=None, clock=NO_CLOCK):
        return self._decode(payload, levels, plan, False, clock)[0]

    def decode_checked(self, payload, levels, plan, *, shard=None,
                       clock=NO_CLOCK):
        """``decode`` plus a bool validity verdict per stream and bucket,
        (shard_nb,) or (M, shard_nb): True iff the bucket's checksum word
        matches its symbols and norm bits (always, without an integrity
        plan)."""
        return self._decode(payload, levels, plan, True, clock)

    def decode_mean(self, payload, levels, plan, transport, *, shard=None,
                    checked=False, clock=NO_CLOCK):
        """One fused ``dequantize_mean`` over the gathered streams' codes,
        weighted as ``transport.mean_weights`` says; ``row(w)`` decodes
        stream w from the codes kept (int8 up to 7 bits)."""
        codes, norms, valid, _ = self._codes(payload, levels, plan, checked,
                                             clock)
        w = transport.mean_weights(valid)
        mean = ops.dequantize_mean_op(
            codes, norms, levels, None if w is None else w.to(codes.device),
            valid).view(-1)
        clock.mark("decode")

        def row(m):
            return ops.dequantize_op(codes[m], norms[m], levels).view(-1)

        return MeanDecode(mean, valid, row)

    def requantize(self, vb: torch.Tensor, levels: torch.Tensor, *,
                   plan: WirePlan | None = None, chunk: int = 0,
                   u: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """Value-space wire round trip Q(vb) of (nb, bucket_size) values:
        norms take the packed wire round trip, so values match the wire's
        bytes.  Every segment has one layout, so ``plan`` and ``chunk``
        (which segment ``vb`` holds) change nothing, and ``vb`` may hold
        the rows of several segments at once."""
        del plan, chunk
        u = rounding_uniforms(vb.shape, vb.device, u, generator)
        codes, norms = ops.quantize_op(vb, u, levels,
                                       norm_type=self.norm_type)
        return ops.dequantize_op(codes, self._wire_norms(norms), levels)


# ---------------------------------------------------------------------------
# entropy codec: the metered H(L) cost realized as coded bytes
# ---------------------------------------------------------------------------

_FLAG = 1 << 31           # header bit 31: the bucket fell back to fixed width


def _pack_rows(sym: torch.Tensor, bits: int, cap: int) -> torch.Tensor:
    """Each row of unsigned symbols packed into its own ``cap`` words, as
    one pack per bucket gives: rows are zero-padded to whole groups of 32
    symbols, which only appends zero bits to each row's words."""
    pad = -sym.shape[1] % 32
    if pad:
        sym = torch.nn.functional.pad(sym, (0, pad))
    return packing.pack(sym, bits).view(sym.shape[0], -1)[:, :cap]


def _unpack_rows(words: torch.Tensor, n: int, bits: int) -> torch.Tensor:
    """Inverse of ``_pack_rows``: (rows, cap) words -> (rows, n) symbols."""
    n32 = n + (-n % 32)
    need = n32 * bits // 32
    if need != words.shape[1]:
        words = torch.nn.functional.pad(words, (0, need - words.shape[1]))
    return packing.unpack(words, words.shape[0] * n32, bits).view(
        -1, n32)[:, :n]


@dataclasses.dataclass(frozen=True)
class EntropyCodec(UniformCodec):
    """Canonical-Huffman entropy coding of the uniform symbol stream.

    The same quantize kernel and uniforms as ``UniformCodec``, so decoded
    values are bit-exact with it; each bucket's symbols travel as
    variable-length codewords of a static table over the ``2L - 1``
    signed-symbol alphabet (``coding.entropy_table``), LSB first.

    Wire layout of one payload segment (``shard_nb`` buckets)::

        [ checksum words: shard_nb (integrity plans only)              ]
        [ header: shard_nb words - bit 31 = fixed-width fallback flag,
                  bits 0..30 = coded bit length of the bucket          ]
        [ bucket 0 region: cap_words words (worst-case capacity)       ]
        ...
        norm side-channel: unchanged (packed bucket norms)

    ``cap_words`` is the fixed-width word count of one bucket, so payloads
    are shape-static and every segment has one layout.  A bucket whose
    coded run would overflow its capacity falls back to the fixed-width
    pack in place (its flag bit set).  ``measured_bits_per_coord`` bills
    ``ceil(coded_bits / 32)`` words a bucket, not the capacity.

    The table arithmetic runs in int64 (codewords reach 32 bits, and an
    int32 shift would sign-extend); words convert to int32 bit patterns at
    the wire.  Encode runs over row chunks of ``packing.CHUNK_SYMBOLS``
    symbols.  Decode is a sequential scan of ``bucket_size`` steps over
    all buckets at once: at each bit position the next <= 32 bits are
    matched against the whole table, and the first hit wins.
    """

    huff_lengths: tuple = ()
    huff_codes: tuple = ()

    def __post_init__(self):
        from .coding import MAX_CODE_BITS
        S = 2 * self.num_levels - 1
        if len(self.huff_lengths) != S or len(self.huff_codes) != S:
            raise ValueError(
                f"entropy table must cover the {S}-symbol signed "
                f"alphabet, got {len(self.huff_lengths)} lengths / "
                f"{len(self.huff_codes)} codes (build one with "
                "coding.entropy_table or entropy_wrap)")
        bad = [n for n in self.huff_lengths
               if not 1 <= int(n) <= MAX_CODE_BITS]
        if bad:
            raise ValueError(
                f"codeword lengths must be in [1, {MAX_CODE_BITS}], "
                f"got {bad}")

    @property
    def _wire_bits(self) -> int:
        return packing.wire_bits_for(self.num_levels)

    @property
    def cap_words(self) -> int:
        """Worst-case capacity of one bucket's coded region (its
        fixed-width word count, so the fallback always fits)."""
        return packing.packed_words(self.bucket_size, self._wire_bits)

    @property
    def nominal_bits_per_coord(self) -> float:
        # worst-case (capacity) accounting: header + fixed-width budget
        return (32.0 * (1 + self.cap_words) / self.bucket_size
                + self._norm_bits_per_coord)

    def plan_buckets(self, nb: int, *, shards: int = 1,
                     d: int | None = None) -> WirePlan:
        if nb % shards:
            raise ValueError(f"nb={nb} not divisible by shards={shards}")
        if d is None:
            d = nb * self.bucket_size
        snb = nb // shards
        cw = snb * (1 + self.cap_words)
        if self.integrity:
            cw += snb                     # per-bucket checksum words
        nw = packing.norm_words(snb, self.norm_dtype)
        return WirePlan(d=d, bucket_size=self.bucket_size, nb=nb,
                        shards=shards, code_words=cw, norm_words=nw,
                        bits_per_coord=32.0 * shards * (cw + nw) / d,
                        integrity=self.integrity, variable=True)

    def _table(self, device) -> tuple[torch.Tensor, ...]:
        """(lengths, codewords, codeword masks) as int64 on ``device``."""
        lens = torch.tensor(self.huff_lengths, dtype=torch.int64,
                            device=device)
        codes = torch.tensor(self.huff_codes, dtype=torch.int64,
                             device=device)
        return lens, codes, (1 << lens) - 1

    def _code_rows(self, sym: torch.Tensor, table) -> tuple[torch.Tensor,
                                                            torch.Tensor]:
        """(k, bucket_size) unsigned symbols -> (k,) headers and (k,
        cap_words) regions, int32 bit patterns."""
        len_t, code_t, _ = table
        cap = self.cap_words
        s64 = sym.to(torch.int64)
        lens = len_t[s64]
        tot = lens.sum(dim=1)
        fallback = tot > 32 * cap
        # codeword fragments at cumulative bit offsets; a codeword of <= 32
        # bits spills into at most one following word.  The fragments of a
        # word occupy disjoint bits, so adding them is or-ing them.  An
        # overflowing bucket's indices are clamped onto a spare word, and
        # its region is replaced by the fixed-width pack.
        pos = torch.cumsum(lens, dim=1) - lens
        del lens
        widx = pos >> 5
        off = pos & 31
        del pos
        cw = code_t[s64]
        del s64
        var = torch.zeros((sym.shape[0], cap + 1), dtype=torch.int64,
                          device=sym.device)
        var.scatter_add_(1, widx.clamp(max=cap), (cw << off) & packing.MASK32)
        var.scatter_add_(1, (widx + 1).clamp(max=cap), cw >> (32 - off))
        region = packing.to_int32_bits(var[:, :cap])
        del var, widx, off, cw
        fb = fallback.nonzero().squeeze(1)
        if fb.numel():
            region[fb] = _pack_rows(sym[fb], self._wire_bits, cap)
        used = torch.where(fallback, self.bucket_size * self._wire_bits, tot)
        header = packing.to_int32_bits(used | (fallback.to(torch.int64)
                                               << 31))
        return header, region

    def encode(self, vb: torch.Tensor, levels: torch.Tensor, *,
               plan: WirePlan | None = None,
               u: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               clock=NO_CLOCK) -> WirePayload:
        if plan is None:
            plan = self.plan_buckets(vb.shape[0])
        u = rounding_uniforms(vb.shape, vb.device, u, generator)
        codes, norms = ops.quantize_op(vb, u, levels,
                                       norm_type=self.norm_type)
        del u
        clock.mark("encode")
        L = levels.shape[0]
        snb, cap = plan.shard_nb, self.cap_words
        head = snb if self.integrity else 0
        table = self._table(vb.device)
        if self.integrity:
            nbits = packing.norm_bit_patterns(norms, self.norm_dtype)
        words = torch.empty((plan.shards, plan.code_words),
                            dtype=torch.int32, device=vb.device)
        rows = max(1, packing.CHUNK_SYMBOLS // self.bucket_size)
        for s in range(plan.shards):
            seg = words[s]
            regions = seg[head + snb:].view(snb, cap)
            for r in range(0, snb, rows):
                b0, k = s * snb + r, min(rows, snb - r)
                sym = packing.bias_codes(codes[b0:b0 + k], L)
                if self.integrity:
                    seg[r:r + k] = packing.bucket_checksums(
                        sym, nbits[b0:b0 + k])
                    clock.mark("checksum")
                seg[head + r:head + r + k], regions[r:r + k] = \
                    self._code_rows(sym, table)
                clock.mark("pack")
        payload = self._payload(words, norms, plan)
        clock.mark("pack")
        return payload

    def _huffman_decode(self, regions: torch.Tensor) -> torch.Tensor:
        """(M, snb, cap) region words -> (M, snb, bucket_size) signed
        codes of ``code_dtype(L)``, each bucket decoded as a Huffman run.
        Reads past a region give zero words, as the reference's clamped
        reads of its zero-padded region do."""
        M, snb, cap = regions.shape
        L = self.num_levels
        len_t, code_t, mask_t = self._table(regions.device)
        padded = torch.nn.functional.pad(regions, (0, 1))
        codes = torch.empty((M, snb, self.bucket_size), dtype=code_dtype(L),
                            device=regions.device)
        pos = torch.zeros((M, snb, 1), dtype=torch.int64,
                          device=regions.device)
        one = torch.tensor([0, 1], dtype=torch.int64, device=regions.device)
        for t in range(self.bucket_size):
            off = pos & 31
            w = packing.from_int32_bits(padded.gather(
                2, ((pos >> 5) + one).clamp_(max=cap)))
            lo, hi = w[..., :1], w[..., 1:]
            u = (lo >> off) | torch.where(
                off > 0, (hi << ((32 - off) & 31)) & packing.MASK32, 0)
            s = ((u & mask_t) == code_t).to(torch.int32).argmax(
                dim=2, keepdim=True)
            pos += len_t[s]
            codes[:, :, t:t + 1] = s - (L - 1)   # symbol -> signed code
        return codes

    def _codes(self, payload, levels, plan, want_valid, clock):
        words, nwords = payload
        single = words.dim() == 1
        if single:
            words, nwords = words[None], nwords[None]
        snb, bs, cap = plan.shard_nb, self.bucket_size, self.cap_words
        wb = self._wire_bits
        M = words.shape[0]
        L = levels.shape[0]
        head = snb if plan.integrity else 0
        norms = self._norm_rows(nwords, snb)
        headers = packing.from_int32_bits(words[:, head:head + snb])
        fallback = headers >= _FLAG
        regions = words[:, head + snb:head + snb * (1 + cap)].view(M, snb,
                                                                   cap)
        codes = self._huffman_decode(regions)
        fb = fallback.nonzero(as_tuple=True)
        if fb[0].numel():
            codes[fb] = (_unpack_rows(regions[fb], bs, wb) - (L - 1)).to(
                codes.dtype)
        clock.mark("unpack")
        valid = None
        if want_valid:
            valid = torch.ones((M, snb), dtype=torch.bool, device=words.device)
            if plan.integrity:
                for m in range(M):
                    valid[m] = self._checksums(codes[m], norms[m],
                                               L) == words[m, :snb]
                # header sanity: a fallback bucket's length is exactly the
                # fixed-width run, a coded bucket's fits its capacity
                used = headers & (_FLAG - 1)
                valid &= torch.where(fallback, used == bs * wb,
                                     used <= 32 * cap)
                clock.mark("checksum")
        return codes, norms, valid, single

    def decode_checked(self, payload, levels, plan, *, shard=None,
                       clock=NO_CLOCK):
        """``decode`` plus a bool validity verdict per stream and bucket:
        its checksum word matches and its header is sane."""
        return self._decode(payload, levels, plan, True, clock)

    # requantize: UniformCodec's; entropy coding is lossless on symbols

    def measured_bits_per_coord(self, payload, plan):
        words = payload.words
        if words.dim() == 1:
            words = words[None]
        snb = plan.shard_nb
        off = snb if plan.integrity else 0
        used = packing.from_int32_bits(words[:, off:off + snb]) & (_FLAG - 1)
        # a corrupt header cannot bill more than the bucket's capacity
        used = used.clamp(max=32 * self.cap_words)
        coded = int(((used + 31) >> 5).sum())          # whole words
        total = coded + words.shape[0] * (snb + off + plan.norm_words)
        return 32.0 * total / plan.d


def _host_probs(level_probs) -> np.ndarray | None:
    if isinstance(level_probs, torch.Tensor):
        return level_probs.detach().cpu().numpy()
    return None if level_probs is None else np.asarray(level_probs)


def entropy_wrap(base: GradientCodec, level_probs=None) -> EntropyCodec:
    """Wrap a base codec's wire in the canonical-Huffman entropy coder.

    ``level_probs`` are magnitude-level occupancies
    (``coding.level_probabilities`` of the grid under fitted stats);
    None installs the cold-start table of uniform joint occupancies.
    Only the uniform symbol stream is entropy-codable.
    """
    from .coding import entropy_table
    if type(base) not in (UniformCodec, EntropyCodec):
        raise ValueError(
            "entropy coding wraps the uniform symbol stream; got "
            f"{type(base).__name__} (mixed-width and sparse payloads "
            "have no single-alphabet symbol run to code)")
    lengths, codes = entropy_table(_host_probs(level_probs), base.num_levels)
    return EntropyCodec(bucket_size=base.bucket_size,
                        norm_type=base.norm_type,
                        norm_dtype=base.norm_dtype,
                        integrity=base.integrity,
                        num_levels=base.num_levels,
                        huff_lengths=lengths, huff_codes=codes)


def entropy_codec_for_scheme(scheme) -> EntropyCodec:
    """The scheme's entropy codec with the gaussian-prior table: normalized
    magnitudes of an i.i.d.-gaussian bucket sit near ``1/sqrt(bucket_size)``
    under L2 norms, ``1/sqrt(2 ln bucket_size)`` under L-inf; the table is
    fit to that one-component prior (host-side, on the CPU)."""
    from .coding import level_probabilities
    from .stats import TruncNormStats
    if scheme.norm_type == NORM_LINF:
        scale = 1.0 / np.sqrt(2.0 * np.log(max(scheme.bucket_size, 2)))
    else:
        scale = 1.0 / np.sqrt(scheme.bucket_size)
    prior = TruncNormStats(mu=torch.tensor([scale], dtype=torch.float32),
                           sigma=torch.tensor([scale], dtype=torch.float32),
                           gamma=torch.tensor([1.0], dtype=torch.float32))
    probs = level_probabilities(
        scheme.init_levels("cpu").to(torch.float32), prior)
    return entropy_wrap(codec_for_scheme(scheme), probs)


def entropy_codec_from_gradient(flat: torch.Tensor, scheme,
                                levels: torch.Tensor | None = None
                                ) -> EntropyCodec:
    """One gradient -> a fitted canonical-Huffman table: one
    ``bucket_stats`` sweep, the mixture the level updates fit, and the
    occupancies of the (current) grid under it."""
    from .coding import level_probabilities
    from .stats import stats_from_moments
    flat = flat.reshape(-1)
    base = codec_for_scheme(scheme)
    vb = base.bucketize(flat, base.plan(flat.shape[0]))
    norms, mu, var = ops.bucket_stats_op(vb, norm_type=scheme.norm_type)
    nb_valid = max(flat.shape[0] // scheme.bucket_size, 1)
    stats = stats_from_moments(
        mu[:nb_valid], var[:nb_valid], norms[:nb_valid],
        weighted=scheme.weighted_stats,
        max_components=scheme.max_stat_components)
    if levels is None:
        levels = scheme.init_levels(flat.device)
    return entropy_wrap(base, level_probabilities(
        levels.to(torch.float32), stats))


# ---------------------------------------------------------------------------
# mixed-width codec: per-bucket widths, one tensor, one wire
# ---------------------------------------------------------------------------

class _Group(NamedTuple):
    """One width group inside one segment."""

    bits: int            # scheme bits of the group's grid
    nlev: int            # 2**bits levels
    local_idx: tuple     # bucket indices local to the segment
    word_off: int        # offset into the segment's word stream
    word_cnt: int


@functools.lru_cache(maxsize=256)
def _segment_layouts(widths: tuple, shards: int,
                     bucket_size: int) -> tuple:
    """Per-segment width-group layouts: ``layouts[s]`` is a tuple of
    ``_Group`` covering segment ``s``'s buckets, words concatenated in
    ascending-width order, each group word-aligned."""
    nb = len(widths)
    snb = nb // shards
    layouts = []
    for s in range(shards):
        seg = np.asarray(widths[s * snb:(s + 1) * snb])
        groups, off = [], 0
        for b in sorted(set(seg.tolist())):
            loc = tuple(np.nonzero(seg == b)[0].tolist())
            nlev = _num_levels_for_bits(b)
            cnt = packing.packed_words(len(loc) * bucket_size,
                                       packing.wire_bits_for(nlev))
            groups.append(_Group(bits=b, nlev=nlev, local_idx=loc,
                                 word_off=off, word_cnt=cnt))
            off += cnt
        layouts.append(tuple(groups))
    return tuple(layouts)


@dataclasses.dataclass(frozen=True)
class MixedWidthCodec(GradientCodec):
    """Per-bucket wire widths inside one tensor.

    ``widths`` is a per-bucket scheme-bits pattern, tiled cyclically over
    the plan's bucket count (a full assignment from
    ``assign_mixed_widths`` is the common case).  Each width group
    quantizes once, over its gathered rows, on ``resample_levels(levels,
    2**bits)``, so level adaptation still happens once, on the base grid.
    A segment's symbol stream is its groups' fixed-width packs in
    ascending width, each word-aligned, zero-padded to the plan's
    ``code_words``.
    """

    widths: tuple = ()

    def __post_init__(self):
        if self.integrity:
            raise ValueError(
                "MixedWidthCodec has no integrity layout (the ragged "
                "width-group stream carries no per-bucket checksum "
                "slot); use the uniform or entropy codec for "
                "fault-tolerant wires")
        if not self.widths:
            raise ValueError("MixedWidthCodec needs a non-empty widths "
                             "pattern (per-bucket scheme bits)")
        bad = [b for b in self.widths if not 1 <= int(b) <= 8]
        if bad:
            raise ValueError(f"widths must be in [1, 8], got {bad}")

    @property
    def chunkable(self) -> bool:
        return False

    @property
    def mean_scheme_bits(self) -> float:
        return float(np.mean(self.widths))

    @property
    def nominal_bits_per_coord(self) -> float:
        wire = np.mean([packing.wire_bits_for(_num_levels_for_bits(int(b)))
                        for b in self.widths])
        return float(wire) + self._norm_bits_per_coord

    def plan_buckets(self, nb: int, *, shards: int = 1,
                     d: int | None = None) -> WirePlan:
        if nb % shards:
            raise ValueError(f"nb={nb} not divisible by shards={shards}")
        if d is None:
            d = nb * self.bucket_size
        widths = tuple(int(b) for b in np.resize(
            np.asarray(self.widths, np.int64), nb))
        layouts = _segment_layouts(widths, shards, self.bucket_size)
        cw = max(sum(g.word_cnt for g in seg) for seg in layouts)
        nw = packing.norm_words(nb // shards, self.norm_dtype)
        return WirePlan(d=d, bucket_size=self.bucket_size, nb=nb,
                        shards=shards, code_words=cw, norm_words=nw,
                        bits_per_coord=32.0 * shards * (cw + nw) / d,
                        widths=widths)

    def encode(self, vb: torch.Tensor, levels: torch.Tensor, *,
               plan: WirePlan | None = None,
               u: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               clock=NO_CLOCK) -> WirePayload:
        """(nb, bucket_size) -> packed payload, segmented per ``plan``;
        ``u`` as in ``UniformCodec.encode``."""
        if plan is None:
            plan = self.plan_buckets(vb.shape[0])
        u = rounding_uniforms(vb.shape, vb.device, u, generator)
        dev = vb.device
        widths = np.asarray(plan.widths)
        codes_by, row_of = {}, np.zeros(plan.nb, np.int64)
        norms = torch.zeros(plan.nb, dtype=torch.float32, device=dev)
        for b in sorted(set(widths.tolist())):
            idx = np.nonzero(widths == b)[0]
            row_of[idx] = np.arange(len(idx))
            rows = torch.from_numpy(idx).to(dev)
            codes_by[b], norms[rows] = ops.quantize_op(
                vb[rows], u[rows],
                resample_levels(levels, _num_levels_for_bits(b)),
                norm_type=self.norm_type)
        del u
        clock.mark("encode")
        snb = plan.shard_nb
        words = torch.zeros((plan.shards, plan.code_words), dtype=torch.int32,
                            device=dev)
        layouts = _segment_layouts(plan.widths, plan.shards, self.bucket_size)
        for s, seg in enumerate(layouts):
            for g in seg:
                rows = torch.from_numpy(
                    row_of[np.asarray(g.local_idx) + s * snb]).to(dev)
                words[s, g.word_off:g.word_off + g.word_cnt] = \
                    packing.pack_signed(codes_by[g.bits][rows], g.nlev)
        payload = self._payload(words, norms, plan)
        clock.mark("pack")
        return payload

    def _segment_codes(self, words, seg, clock):
        """(M, code_words) streams of ONE segment -> each width group's
        (M, group buckets, bucket_size) signed codes of its own
        ``code_dtype``, in the segment's group order."""
        bs = self.bucket_size
        out = []
        for g in seg:
            cnt = len(g.local_idx)
            codes = torch.empty((words.shape[0], cnt, bs),
                                dtype=code_dtype(g.nlev), device=words.device)
            for m, w in enumerate(words):
                packing.unpack_signed(w[g.word_off:g.word_off + g.word_cnt],
                                      cnt * bs, g.nlev, out=codes[m])
            out.append(codes)
        clock.mark("unpack")
        return out

    def _decode_segment(self, words, norms, levels, seg, clock):
        """(M, code_words) streams of ONE segment -> (M, shard_n)."""
        M, snb = norms.shape
        bs = self.bucket_size
        out = torch.zeros((M, snb, bs), dtype=torch.float32,
                          device=words.device)
        for g, codes in zip(seg, self._segment_codes(words, seg, clock)):
            loc = torch.tensor(g.local_idx, dtype=torch.int64,
                               device=words.device)
            vals = ops.dequantize_op(
                codes.view(-1, bs), norms[:, loc].reshape(-1),
                resample_levels(levels, g.nlev))
            out[:, loc] = vals.view(M, -1, bs)
            del vals
            clock.mark("decode")
        return out.view(M, snb * bs)

    def decode(self, payload, levels, plan, *, shard=None, clock=NO_CLOCK):
        words, nwords = payload
        single = words.dim() == 1
        if single:
            words, nwords = words[None], nwords[None]
        norms = self._norm_rows(nwords, plan.shard_nb)
        layouts = _segment_layouts(plan.widths, plan.shards,
                                   self.bucket_size)
        if plan.shards == 1:
            vals = self._decode_segment(words, norms, levels, layouts[0],
                                        clock)
            return vals[0] if single else vals
        if shard is None:
            # stream i carries segment i (one's own sharded payload)
            if words.shape[0] != plan.shards:
                raise ValueError(
                    f"diagonal decode needs {plan.shards} streams, got "
                    f"{words.shape[0]}")
            return torch.stack([
                self._decode_segment(words[s][None], norms[s][None], levels,
                                     layouts[s], clock)[0]
                for s in range(plan.shards)])
        return self._decode_segment(words, norms, levels, layouts[int(shard)],
                                    clock)

    def decode_mean(self, payload, levels, plan, transport, *, shard=None,
                    checked=False, clock=NO_CLOCK):
        """The streams of one segment (an unsharded plan, or ``shard``
        named): one fused ``dequantize_mean`` a width group, on its
        resampled grid; ``row(w)`` decodes stream w's groups from the
        codes kept.  Otherwise (one's own sharded payload, stream i
        segment i) the default: decode, then the transport's mean."""
        if checked or (plan.shards > 1 and shard is None):
            return super().decode_mean(payload, levels, plan, transport,
                                       shard=shard, checked=checked,
                                       clock=clock)
        words, nwords = payload
        snb, bs = plan.shard_nb, self.bucket_size
        norms = self._norm_rows(nwords, snb)
        seg = _segment_layouts(plan.widths, plan.shards,
                               bs)[0 if plan.shards == 1 else int(shard)]
        codes = self._segment_codes(words, seg, clock)
        w = transport.mean_weights(None)
        w = None if w is None else w.to(words.device)
        groups = [(torch.tensor(g.local_idx, dtype=torch.int64,
                                device=words.device),
                   resample_levels(levels, g.nlev)) for g in seg]
        mean = torch.zeros((snb, bs), dtype=torch.float32,
                           device=words.device)
        for (loc, lv), c in zip(groups, codes):
            mean[loc] = ops.dequantize_mean_op(c, norms[:, loc], lv, w)
        clock.mark("decode")

        def row(m):
            out = torch.zeros((snb, bs), dtype=torch.float32,
                              device=words.device)
            for (loc, lv), c in zip(groups, codes):
                out[loc] = ops.dequantize_op(c[m], norms[m, loc], lv)
            return out.view(-1)

        return MeanDecode(mean.view(-1), None, row)

    def requantize(self, vb: torch.Tensor, levels: torch.Tensor, *,
                   plan: WirePlan, chunk: int = 0,
                   u: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """Value-space wire round trip Q(vb) of segment ``chunk``'s
        (shard_nb, bucket_size) buckets; norms take the packed wire round
        trip."""
        seg = _segment_layouts(plan.widths, plan.shards,
                               self.bucket_size)[int(chunk)]
        u = rounding_uniforms(vb.shape, vb.device, u, generator)
        out = torch.zeros_like(vb)
        for g in seg:
            loc = torch.tensor(g.local_idx, dtype=torch.int64,
                               device=vb.device)
            lv = resample_levels(levels, g.nlev)
            codes, nrm = ops.quantize_op(vb[loc], u[loc], lv,
                                         norm_type=self.norm_type)
            out[loc] = ops.dequantize_op(codes, self._wire_norms(nrm), lv)
        return out


# ---------------------------------------------------------------------------
# width assignment: where should the bits go?
# ---------------------------------------------------------------------------

def _bucket_psi(mu: torch.Tensor, sigma: torch.Tensor,
                levels: torch.Tensor) -> torch.Tensor:
    """Eq. 3's Psi of ``levels`` under each bucket's one-component
    truncated normal (mu[i], sigma[i]): (nb,)."""
    from .stats import (TruncNormStats, partial_moment0, partial_moment1,
                        partial_moment2)
    stats = TruncNormStats(mu=mu[:, None], sigma=sigma[:, None],
                           gamma=torch.ones_like(mu)[:, None])
    a, c = levels[:-1, None], levels[1:, None]
    m0 = partial_moment0(stats, a, c)
    m1 = partial_moment1(stats, a, c)
    m2 = partial_moment2(stats, a, c)
    return torch.sum(-m2 + (a + c) * m1 - a * c * m0, dim=0)


def assign_mixed_widths(mu, sigma, bucket_norms, base_levels, *,
                        mean_bits: int, min_bits: int = 1,
                        max_bits: int = 8) -> tuple:
    """Greedy per-bucket bit allocation under a mean-bits budget.

    For every candidate width ``b`` the expected quantization error of
    bucket ``i`` is ``||v_i||^2 * Psi_i(resample_levels(levels, 2**b))``
    (Eq. 3 with one truncated-normal component).  Allocation starts at
    ``min_bits`` everywhere and grants +1 scheme bit to the bucket with
    the largest error reduction per wire bit until the budget ``nb *
    wire_bits(2**mean_bits)`` is spent.  Returns a per-bucket scheme-bits
    tuple for ``MixedWidthCodec``.
    """
    mu = np.asarray(mu, np.float64)
    sigma = np.asarray(sigma, np.float64)
    w2 = np.asarray(bucket_norms, np.float64) ** 2
    nb = mu.shape[0]
    base = torch.as_tensor(np.asarray(base_levels, np.float32))
    tmu = torch.from_numpy(mu.astype(np.float32))
    tsig = torch.from_numpy(sigma.astype(np.float32))
    err = {}
    for b in range(min_bits, max_bits + 1):
        lv = resample_levels(base, _num_levels_for_bits(b))
        err[b] = _bucket_psi(tmu, tsig, lv).numpy().astype(np.float64) * w2

    def wire(b):
        return packing.wire_bits_for(_num_levels_for_bits(b))

    budget = nb * wire(mean_bits)
    widths = np.full(nb, min_bits, np.int64)
    cost = nb * wire(min_bits)
    heap = []
    for i in range(nb):
        if min_bits < max_bits:
            dw = wire(min_bits + 1) - wire(min_bits)
            gain = (err[min_bits][i] - err[min_bits + 1][i]) / max(dw, 1)
            heapq.heappush(heap, (-gain, i, min_bits + 1, dw))
    while heap:
        _, i, b_next, dw = heapq.heappop(heap)
        if widths[i] != b_next - 1 or cost + dw > budget:
            continue
        widths[i] = b_next
        cost += dw
        if b_next < max_bits:
            dw2 = wire(b_next + 1) - wire(b_next)
            gain = (err[b_next][i] - err[b_next + 1][i]) / max(dw2, 1)
            heapq.heappush(heap, (-gain, i, b_next + 1, dw2))
    return tuple(int(b) for b in widths)


def mixed_widths_from_gradient(flat: torch.Tensor, scheme) -> tuple:
    """One gradient -> a width assignment: one ``bucket_stats`` sweep over
    the codec-aligned buckets of ``flat``, a conditioning floor on sigma,
    then ``assign_mixed_widths`` under the scheme's own mean bits."""
    flat = flat.reshape(-1)
    codec = codec_for_scheme(scheme)
    vb = codec.bucketize(flat, codec.plan(flat.shape[0]))
    norms, mu, var = ops.bucket_stats_op(vb, norm_type=scheme.norm_type)
    # alignment padding is all-zero; keep only fully-populated buckets
    nb_valid = max(flat.shape[0] // scheme.bucket_size, 1)
    return assign_mixed_widths(
        mu[:nb_valid].cpu().numpy(),
        np.clip(np.sqrt(var[:nb_valid].cpu().numpy()), 1e-4, None),
        norms[:nb_valid].cpu().numpy(),
        scheme.init_levels("cpu").numpy(), mean_bits=scheme.bits)


# ---------------------------------------------------------------------------
# factories
# ---------------------------------------------------------------------------

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


def make_codec(scheme, kind: str = "uniform", widths: tuple = (), *,
               integrity: bool = False) -> GradientCodec:
    """The codec a ``TrainConfig`` selects.

    ``kind='mixed_width'`` with empty ``widths`` falls back to the
    budget-neutral ``(bits-1, bits+1)`` cycle (wire widths are scheme bits
    + 1, so it ships the uniform codec's mean bits/coordinate); at bits 1
    or 8, where no symmetric cycle exists, to ``(bits,)``.
    ``kind='entropy[:base]'`` wraps the base codec (only ``uniform``) in
    the entropy coder with the gaussian-prior table
    (``entropy_codec_for_scheme``).
    """
    if kind == "uniform":
        codec = codec_for_scheme(scheme)
        if integrity:
            codec = dataclasses.replace(codec, integrity=True)
        return codec
    if kind == "entropy" or kind.startswith("entropy:"):
        base_kind = kind.partition(":")[2] or "uniform"
        if base_kind != "uniform":
            raise ValueError(
                f"entropy coding supports base codec 'uniform', got "
                f"{base_kind!r} (mixed-width/sparse symbol streams are "
                "not single-alphabet)")
        codec = entropy_codec_for_scheme(scheme)
        if integrity:
            codec = dataclasses.replace(codec, integrity=True)
        return codec
    if kind == "mixed_width":
        if integrity:
            raise ValueError(
                "integrity=True is not supported for codec kind "
                "'mixed_width' (no per-bucket checksum slot in the "
                "ragged width-group stream)")
        if not widths:
            if scheme.bits - 1 < 1 or scheme.bits + 1 > 8:
                widths = (scheme.bits,)
            else:
                widths = (scheme.bits - 1, scheme.bits + 1)
        return MixedWidthCodec(bucket_size=scheme.bucket_size,
                               norm_type=scheme.norm_type,
                               norm_dtype=scheme.norm_dtype,
                               widths=tuple(int(b) for b in widths))
    raise ValueError(f"unknown codec kind {kind!r}; "
                     "known: ('uniform', 'mixed_width', "
                     "'entropy[:base]')")
