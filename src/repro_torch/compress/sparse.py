"""SparseCodec: the sparse (top-k) wire-payload family.

Dense codecs ship one symbol per coordinate.  ``SparseCodec`` ships only
the ``k`` largest-magnitude coordinates of every bucket, each as a
bit-packed bucket-local index and a quantized value symbol, plus the
packed norm side-channel.  Everything else decodes to exactly 0, so the
mean of M gathered streams is the union of the workers' supports.

One payload segment is laid out as

    [ value symbols: shard_nb*k symbols, wire_bits(L) each ]
    [ indices:       shard_nb*k indices, idx_bits each     ]
    [ norm words:    shard_nb packed bucket norms          ]

with both blocks word-aligned, so every word count, and the exact
bits/coordinate, is static in the ``WirePlan``.

Selection is per bucket by ``|v|``, ties to the lower index (as the
reference's ``jax.lax.top_k``; all-zero padding buckets are all ties),
with the kept indices in ascending order.  Kept values are quantized on
the scheme's grid, normalized by the kept set's norm.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core import packing
from repro_torch.core.codec import (
    GradientCodec, WirePayload, WirePlan, rounding_uniforms)
from repro_torch.kernels import ops
from repro_torch.timing import NO_CLOCK

# Selection sorts row chunks of about this many elements, so that the
# sort's values and int64 indices stay a few hundred MB.
SELECT_CHUNK = 1 << 24


def _idx_bits(bucket_size: int) -> int:
    return max(1, math.ceil(math.log2(bucket_size)))


@dataclasses.dataclass(frozen=True)
class SparseCodec(GradientCodec):
    """Per-bucket top-k magnitude selection; index+value wire payload."""

    num_levels: int = 8   # levels of the kept-value grid (the scheme's)
    k: int = 64           # kept coordinates per bucket

    def __post_init__(self):
        if not 1 <= self.k <= self.bucket_size:
            raise ValueError(
                f"k={self.k} must be in [1, bucket_size={self.bucket_size}]")

    @property
    def kept_fraction(self) -> float:
        return self.k / self.bucket_size

    @property
    def idx_bits(self) -> int:
        return _idx_bits(self.bucket_size)

    @property
    def _wire_bits(self) -> int:
        return packing.wire_bits_for(self.num_levels)

    def rounding_shape(self, nb: int) -> tuple[int, int]:
        """One uniform a kept value."""
        return (nb, self.k)

    def _value_words(self, snb: int) -> int:
        return packing.packed_words(snb * self.k, self._wire_bits)

    def _index_words(self, snb: int) -> int:
        return packing.packed_words(snb * self.k, self.idx_bits)

    def plan_buckets(self, nb: int, *, shards: int = 1,
                     d: int | None = None) -> WirePlan:
        if nb % shards:
            raise ValueError(f"nb={nb} not divisible by shards={shards}")
        if d is None:
            d = nb * self.bucket_size
        snb = nb // shards
        cw = self._value_words(snb) + self._index_words(snb)
        nw = packing.norm_words(snb, self.norm_dtype)
        return WirePlan(d=d, bucket_size=self.bucket_size, nb=nb,
                        shards=shards, code_words=cw, norm_words=nw,
                        bits_per_coord=32.0 * shards * (cw + nw) / d)

    def select(self, vb: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """(nb, bs) -> (kept values (nb, k), ascending int32 indices
        (nb, k)).  A stable descending sort of |v| puts the lower index
        first among equal magnitudes, as the reference's top_k does."""
        nb = vb.shape[0]
        idx = torch.empty((nb, self.k), dtype=torch.int32, device=vb.device)
        rows = max(1, SELECT_CHUNK // self.bucket_size)
        for r in range(0, nb, rows):
            order = torch.sort(vb[r:r + rows].abs(), dim=1, descending=True,
                               stable=True).indices[:, :self.k]
            idx[r:r + rows] = torch.sort(order, dim=1).values
            del order
        return torch.gather(vb, 1, idx.long()), idx

    def encode(self, vb: torch.Tensor, levels: torch.Tensor, *,
               plan: WirePlan | None = None,
               u: torch.Tensor | None = None,
               generator: torch.Generator | None = None,
               clock=NO_CLOCK) -> WirePayload:
        """(nb, bucket_size) -> packed payload; ``u`` (nb, k) uniforms of
        the kept values' rounding, drawn from ``generator`` when None."""
        if plan is None:
            plan = self.plan_buckets(vb.shape[0])
        sel, idx = self.select(vb)
        clock.mark("select")
        u = rounding_uniforms(sel.shape, sel.device, u, generator)
        codes, norms = ops.quantize_op(sel, u, levels,
                                       norm_type=self.norm_type)
        del sel, u
        clock.mark("encode")
        L = levels.shape[0]
        snb = plan.shard_nb
        words = torch.stack([
            torch.cat([packing.pack_signed(codes[j * snb:(j + 1) * snb], L),
                       packing.pack(idx[j * snb:(j + 1) * snb],
                                    self.idx_bits)])
            for j in range(plan.shards)])
        nwords = torch.stack([
            packing.pack_norms(norms[j * snb:(j + 1) * snb], self.norm_dtype)
            for j in range(plan.shards)])
        clock.mark("pack")
        if plan.shards == 1:
            return WirePayload(words=words[0], norm_words=nwords[0])
        return WirePayload(words=words, norm_words=nwords)

    def decode(self, payload, levels, plan, *, shard=None, clock=NO_CLOCK):
        """Every segment has one layout, so any stream decodes the same
        way; each stream's kept values are scattered into a dense row."""
        words, nwords = payload
        single = words.dim() == 1
        if single:
            words, nwords = words[None], nwords[None]
        snb, bs, k = plan.shard_nb, self.bucket_size, self.k
        vw = self._value_words(snb)
        M = words.shape[0]
        L = levels.shape[0]
        norms = torch.stack([packing.unpack_norms(w, snb, self.norm_dtype)
                             for w in nwords])
        sym = torch.empty((M, snb * k), dtype=torch.int32,
                          device=words.device)
        for m in range(M):
            sym[m] = packing.unpack_signed(words[m, :vw], snb * k, L)
        clock.mark("unpack")
        vals = ops.dequantize_op(sym.view(M * snb, k), norms.reshape(-1),
                                 levels).view(M, snb, k)
        del sym
        dense = torch.zeros((M, snb * bs), dtype=torch.float32,
                            device=words.device)
        for m in range(M):
            idx = packing.unpack(words[m, vw:], snb * k, self.idx_bits)
            idx = idx.view(snb, k).long().clamp_(max=bs - 1)
            dense[m].view(snb, bs).scatter_(1, idx, vals[m])
            del idx
        clock.mark("decode")
        return dense[0] if single else dense

    def requantize(self, vb: torch.Tensor, levels: torch.Tensor, *,
                   plan: WirePlan | None = None, chunk: int = 0,
                   u: torch.Tensor | None = None,
                   generator: torch.Generator | None = None) -> torch.Tensor:
        """Value-space round trip: the kept values' wire round trip,
        scattered back; every other coordinate is 0.  ``u`` are (nb, k)
        uniforms; every segment has one layout (``plan`` and ``chunk``
        change nothing)."""
        del plan, chunk
        sel, idx = self.select(vb)
        u = rounding_uniforms(sel.shape, sel.device, u, generator)
        codes, norms = ops.quantize_op(sel, u, levels,
                                       norm_type=self.norm_type)
        wn = packing.unpack_norms(packing.pack_norms(norms, self.norm_dtype),
                                  norms.shape[0], self.norm_dtype)
        vals = ops.dequantize_op(codes, wn, levels)
        return torch.zeros_like(vb, dtype=torch.float32).scatter_(
            1, idx.long(), vals)


def sparse_codec_for_scheme(scheme, k: int | None = None) -> SparseCodec:
    """The scheme's sparse codec; ``k=None`` picks the equal-wire-budget
    k, the largest whose index+value cost fits the dense fixed-width
    budget: ``k = floor(bs * wb / (wb + idx_bits))``."""
    wb = packing.wire_bits_for(scheme.num_levels)
    if k is None:
        k = max(1, (scheme.bucket_size * wb)
                // (wb + _idx_bits(scheme.bucket_size)))
    return SparseCodec(num_levels=scheme.num_levels,
                       bucket_size=scheme.bucket_size,
                       norm_type=scheme.norm_type,
                       norm_dtype=scheme.norm_dtype, k=int(k))
