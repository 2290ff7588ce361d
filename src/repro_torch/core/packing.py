"""k-bit <-> 32-bit word packing for the collective wire format.

Signed level indices in [-(L-1), +(L-1)] are biased to unsigned symbols
in [0, 2L-2] and packed ``wire_bits`` per symbol into a dense stream of
32-bit words, bit-identical with the reference package's uint32 words.

Words travel as ``int32`` tensors holding the uint32 bit patterns:
PyTorch's ``uint32`` lacks shifts, addition and scatters on the CPU, so
the arithmetic runs in ``int64`` masked to 32 bits.  Pack and unpack run
over chunks of ``CHUNK_SYMBOLS`` symbols, a multiple of 32: 32 symbols of
b bits fill exactly b words, so every chunk starts on a word boundary and
the int64 temporaries stay a few hundred MB whatever the gradient size.
Inside a chunk, each group of 32 symbols forms its b words by a dense
sum of shifted fragments, with no scatter and no atomics.

``bucket_checksums`` gives the per-bucket integrity words of the
``integrity=`` wire: the reference's uint32 arithmetic, taken in int64
and reduced mod 2**32, over row chunks of about ``CHUNK_SYMBOLS``.
"""
from __future__ import annotations

import math

import torch

CHUNK_SYMBOLS = 1 << 22
MASK32 = 0xFFFFFFFF


def wire_bits_for(num_levels: int) -> int:
    """Bits per symbol for signed indices over `num_levels` magnitudes.

    Symbols: 2*num_levels - 1 (zero is shared between signs).
    """
    n_sym = 2 * num_levels - 1
    return max(1, math.ceil(math.log2(n_sym)))


def packed_words(n: int, bits: int) -> int:
    return -(-(n * bits) // 32)


def to_int32_bits(x: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2**32) -> int32 tensor of the same bits."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def from_int32_bits(w: torch.Tensor) -> torch.Tensor:
    """int32 bit patterns -> int64 values in [0, 2**32)."""
    return w.to(torch.int64) & MASK32


def _group_layout(bits: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Within a group of 32 symbols: each symbol's first word and bit
    offset (both (32,) int64)."""
    pos = torch.arange(32, dtype=torch.int64, device=device) * bits
    return pos >> 5, pos & 31


def _pack_groups(sym: torch.Tensor, bits: int) -> torch.Tensor:
    """(G, 32) int64 symbols -> (G, bits) int64 words."""
    widx, off = _group_layout(bits, sym.device)
    j = torch.arange(bits, dtype=torch.int64, device=sym.device)
    # shift of symbol i into word j: its bit position relative to the
    # word's first bit (negative: the symbol's low bits lie in word j-1)
    shift = (widx * 32 + off)[:, None] - 32 * j[None, :]         # (32, bits)
    lo = (shift >= 0) & (shift < 32)
    hi = (shift < 0) & (shift > -bits)
    s = sym[:, :, None]
    frag = torch.where(lo, (s << shift.clamp(0, 31)) & MASK32,
                       torch.where(hi, s >> (-shift).clamp(0, 31),
                                   torch.zeros((), dtype=torch.int64,
                                               device=sym.device)))
    return frag.sum(dim=1)


def pack(codes: torch.Tensor, bits: int) -> torch.Tensor:
    """Pack unsigned symbols (integers in [0, 2**bits)) into words.

    Returns ``packed_words(n, bits)`` int32 words (uint32 bit patterns).
    """
    codes = codes.reshape(-1)
    n = codes.numel()
    nwords = packed_words(n, bits)
    out = torch.empty(nwords, dtype=torch.int32, device=codes.device)
    mask = (1 << bits) - 1
    for start in range(0, n, CHUNK_SYMBOLS):
        chunk = codes[start:start + CHUNK_SYMBOLS].to(torch.int64) & mask
        pad = -chunk.numel() % 32
        if pad:
            chunk = torch.cat([chunk, chunk.new_zeros(pad)])
        words = _pack_groups(chunk.reshape(-1, 32), bits).reshape(-1)
        w0 = start // 32 * bits
        take = min(words.numel(), nwords - w0)
        out[w0:w0 + take] = to_int32_bits(words[:take])
    return out


def unpack(words: torch.Tensor, n: int, bits: int, *, bias: int = 0,
           out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of pack: recover n unsigned symbols (int32).  With ``bias``
    each symbol less ``bias``, taken a chunk at a time and written into
    ``out`` (n contiguous elements of any integer dtype; int32 when not
    given), so that signed codes come out unbiased in their own width
    with no int32 copy of the stream."""
    words = words.reshape(-1)
    if out is None:
        out = torch.empty(n, dtype=torch.int32, device=words.device)
    out = out.view(-1)
    widx, off = _group_layout(bits, words.device)
    spill = torch.where(off > 0, 32 - off, torch.zeros_like(off))
    mask = (1 << bits) - 1
    for start in range(0, n, CHUNK_SYMBOLS):
        cnt = min(CHUNK_SYMBOLS, n - start)
        groups = -(-cnt // 32)
        w0 = start // 32 * bits
        w = from_int32_bits(words[w0:w0 + groups * bits])
        # zero words past the stream's end, plus one spill word per group
        w = torch.cat([w, w.new_zeros(groups * bits - w.numel())])
        w = torch.cat([w.reshape(groups, bits), w.new_zeros(groups, 1)], 1)
        lo = w[:, widx] >> off
        hi = torch.where(off > 0, (w[:, widx + 1] << spill) & MASK32,
                         torch.zeros_like(lo))
        sym = ((lo | hi) & mask).reshape(-1)[:cnt]
        if bias:
            sym -= bias
        out[start:start + cnt] = sym.to(out.dtype)
    return out


def bias_codes(signed_codes: torch.Tensor, num_levels: int) -> torch.Tensor:
    """Signed index in [-(L-1), L-1] -> unsigned symbol in [0, 2L-2]."""
    return signed_codes.to(torch.int32) + (num_levels - 1)


def unbias_codes(symbols: torch.Tensor, num_levels: int) -> torch.Tensor:
    return symbols.to(torch.int32) - (num_levels - 1)


NORM_DTYPES = ("float32", "float16")


def norm_words(nb: int, norm_dtype: str = "float32") -> int:
    """32-bit words occupied by ``nb`` packed bucket norms."""
    if norm_dtype == "float32":
        return nb
    if norm_dtype == "float16":
        return -(-nb // 2)
    raise ValueError(f"unknown norm_dtype {norm_dtype!r}; known: {NORM_DTYPES}")


def pack_norms(norms: torch.Tensor, norm_dtype: str = "float32"
               ) -> torch.Tensor:
    """Bucket norms -> dense word stream for the wire (int32 bits).

    ``float32`` is a bitcast (1 word a norm); ``float16`` rounds each
    norm to fp16 and packs two per word, the lower half first.
    """
    norms = norms.reshape(-1)
    if norm_dtype == "float32":
        return norms.to(torch.float32).view(torch.int32)
    if norm_dtype == "float16":
        h = norms.to(torch.float16).view(torch.int16).to(torch.int64) & 0xFFFF
        if h.numel() % 2:
            h = torch.cat([h, h.new_zeros(1)])
        pair = h.reshape(-1, 2)
        return to_int32_bits(pair[:, 0] | (pair[:, 1] << 16))
    raise ValueError(f"unknown norm_dtype {norm_dtype!r}; known: {NORM_DTYPES}")


def unpack_norms(words: torch.Tensor, nb: int,
                 norm_dtype: str = "float32") -> torch.Tensor:
    """Inverse of ``pack_norms``: ``nb`` float32 norms (fp16 norms are
    upcast; their rounding is lossy by design)."""
    if norm_dtype == "float32":
        return words.view(torch.float32)[:nb]
    if norm_dtype == "float16":
        w = from_int32_bits(words)
        h = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(-1)[:nb]
        h = torch.where(h >= 1 << 15, h - (1 << 16), h).to(torch.int16)
        return h.view(torch.float16).to(torch.float32)
    raise ValueError(f"unknown norm_dtype {norm_dtype!r}; known: {NORM_DTYPES}")


# Mixing constants of the per-bucket integrity word, as in the reference:
# odd, so every per-position multiplier is invertible mod 2**32 and any
# single-symbol change changes the weighted sum.
_CSUM_SYM_MULT = 0x9E3779B1
_CSUM_NORM_MULT = 0x85EBCA6B
# Nonzero offset: an all-zero row (a dropped or zeroed payload) does not
# checksum to 0, so it fails instead of decoding as a valid zero bucket.
_CSUM_OFFSET = 0x6A09E667


def norm_bit_patterns(norms: torch.Tensor,
                      norm_dtype: str = "float32") -> torch.Tensor:
    """Per-bucket wire bit pattern of each norm (int32 bit patterns).

    The integrity word covers the bits that travel: an fp16 norm gives
    its 16-bit pattern, so recomputing it from decoded norms matches iff
    the norm words arrived intact (decoded fp16 norms are exact upcasts).
    """
    norms = norms.reshape(-1)
    if norm_dtype == "float32":
        return norms.to(torch.float32).view(torch.int32)
    if norm_dtype == "float16":
        return (norms.to(torch.float16).view(torch.int16).to(torch.int32)
                & 0xFFFF)
    raise ValueError(f"unknown norm_dtype {norm_dtype!r}; known: {NORM_DTYPES}")


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """x * c mod 2**32 for int64 x in [0, 2**32): by 16-bit halves of x,
    so no product leaves int64."""
    lo = (x & 0xFFFF) * c
    hi = ((x >> 16) * c) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def bucket_checksums(symbols: torch.Tensor,
                     norm_bits: torch.Tensor) -> torch.Tensor:
    """(nb, bucket_size) unsigned symbols + (nb,) norm bit patterns ->
    (nb,) integrity words (int32 bit patterns of the reference's uint32).

    A position-weighted sum with distinct odd multipliers per coordinate,
    mixed with an xorshift-multiply avalanche.  Products stay below 2**41
    and a bucket's sum below 2**54 (symbols < 2**9, buckets < 2**13 at the
    repo's sizes), so int64 holds them exactly; every later product is
    taken by ``_mul32`` and each step reduced mod 2**32, as the
    reference's uint32 wraps.
    """
    nb, bs = symbols.shape
    dev = symbols.device
    i = torch.arange(bs, dtype=torch.int64, device=dev)
    mult = ((2 * i + 1) * _CSUM_SYM_MULT) & MASK32
    out = torch.empty(nb, dtype=torch.int64, device=dev)
    rows = max(1, CHUNK_SYMBOLS // bs)
    for r in range(0, nb, rows):
        sym = symbols[r:r + rows].to(torch.int64)
        out[r:r + rows] = (sym * mult).sum(dim=1)
    h = (out + _mul32(from_int32_bits(norm_bits.reshape(-1)),
                      _CSUM_NORM_MULT) + _CSUM_OFFSET) & MASK32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    return to_int32_bits(h)


def pack_signed(signed_codes: torch.Tensor, num_levels: int) -> torch.Tensor:
    bits = wire_bits_for(num_levels)
    return pack(bias_codes(signed_codes, num_levels), bits)


def unpack_signed(words: torch.Tensor, n: int, num_levels: int,
                  out: torch.Tensor | None = None) -> torch.Tensor:
    """Inverse of ``pack_signed``: n signed level indices (int32, or into
    ``out``)."""
    bits = wire_bits_for(num_levels)
    return unpack(words, n, bits, bias=num_levels - 1, out=out)
