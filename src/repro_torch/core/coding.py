"""Code-length accounting (paper App. D, Thm 3): closed-form level
occupancy probabilities Pr(l_j) (Prop. 6), their entropy H(L), a host-side
Huffman code built from those probabilities and the Thm-3 bound, plus the
static canonical-Huffman wire table (``entropy_table``) that
``core.codec.EntropyCodec`` codes its symbols with.

The tables are numpy and ``heapq``, as in the reference package, so the
same probabilities give the same integer tables bit for bit.
"""
from __future__ import annotations

import heapq
from typing import Sequence

import numpy as np
import torch

from .packing import wire_bits_for
from .stats import TruncNormStats, partial_moment0, partial_moment1


def level_probabilities(levels: torch.Tensor, stats: TruncNormStats
                        ) -> torch.Tensor:
    """Pr(l_j) under randomized rounding (Prop. 6), closed form.

    Pr(l_j) = int_{l_{j-1}}^{l_j} (r-l_{j-1})/(l_j-l_{j-1}) dF
            + int_{l_j}^{l_{j+1}} (l_{j+1}-r)/(l_{j+1}-l_j) dF
    with one-sided variants at the endpoints.  Sums to 1; a fit that loses
    all its mass to rounding falls back to the uniform distribution.
    """
    n = levels.shape[0]
    if n == 1:
        return torch.ones(1, dtype=levels.dtype, device=levels.device)
    a, b = levels[:-1], levels[1:]
    gap = torch.clamp(b - a, min=1e-12)
    m0 = partial_moment0(stats, a, b)
    m1 = partial_moment1(stats, a, b)
    up = (m1 - a * m0) / gap      # mass rounded up from each bin
    down = (b * m0 - m1) / gap    # mass rounded down
    probs = torch.zeros(n, dtype=levels.dtype, device=levels.device)
    probs[1:] += up
    probs[:-1] += down
    probs = torch.clamp(probs, min=0.0)
    total = torch.sum(probs)
    uniform = torch.full_like(probs, 1.0 / n)
    return torch.where(total > 1e-12, probs / torch.clamp(total, min=1e-12),
                       uniform)


def entropy_bits(probs: torch.Tensor) -> torch.Tensor:
    """H(L) in bits."""
    p = torch.clamp(probs, 1e-12, 1.0)
    return -torch.sum(torch.where(probs > 0, probs * torch.log2(p),
                                  torch.zeros_like(p)))


def huffman_code_lengths(probs: Sequence[float]) -> np.ndarray:
    """Host-side Huffman code lengths for the level symbols.

    Optimal prefix code (Thm 5): H(L) <= E[len] <= H(L) + 1.
    """
    probs = np.asarray(probs, dtype=np.float64)
    n = len(probs)
    if n == 1:
        return np.array([1])
    heap = [(float(p), i, None) for i, p in enumerate(probs)]
    heapq.heapify(heap)
    counter = n
    parents: dict[int, tuple] = {}
    while len(heap) > 1:
        p1, i1, _ = heapq.heappop(heap)
        p2, i2, _ = heapq.heappop(heap)
        parents[counter] = (i1, i2)
        heapq.heappush(heap, (p1 + p2, counter, None))
        counter += 1
    root = heap[0][1]
    lengths = np.zeros(counter, dtype=np.int64)

    stack = [(root, 0)]
    while stack:
        node, depth = stack.pop()
        if node in parents:
            l, r = parents[node]
            stack.append((l, depth + 1))
            stack.append((r, depth + 1))
        else:
            lengths[node] = max(depth, 1)
    return lengths[:n]


def expected_huffman_bits(probs: np.ndarray) -> float:
    """E[len] of the Huffman code for one magnitude symbol."""
    lengths = huffman_code_lengths(np.asarray(probs))
    return float(np.sum(np.asarray(probs) * lengths))


def expected_bits_per_coordinate(levels: torch.Tensor, stats: TruncNormStats,
                                 *, use_huffman: bool = True) -> float:
    """Expected wire bits per coordinate: magnitude symbol + sign bit for
    nonzero symbols (App. D encoding)."""
    probs = level_probabilities(levels, stats).cpu().numpy()
    mag = (expected_huffman_bits(probs) if use_huffman
           else float(np.ceil(np.log2(len(probs)))))
    return mag + (1.0 - probs[0])  # a sign bit whenever the symbol is nonzero


# ---------------------------------------------------------------------------
# canonical-Huffman wire table (consumed by core.codec.EntropyCodec)
# ---------------------------------------------------------------------------

# Longest wire codeword the variable-length packer supports: a codeword
# must fit one 32-bit word so that, at any bit offset, it spills into at
# most one following word.
MAX_CODE_BITS = 32

# Probability floor applied before building the wire table: it bounds the
# depth of the Huffman tree, so even never-seen symbols keep codeword
# lengths far inside MAX_CODE_BITS.
_PROB_FLOOR = 2.0 ** -20


def signed_symbol_probabilities(level_probs: Sequence[float]) -> np.ndarray:
    """Magnitude-level occupancies -> the joint signed-symbol alphabet.

    The wire alphabet is the ``2L - 1`` biased signed indices
    (``packing.bias_codes``): symbol ``L - 1`` is the shared zero, and
    level ``j > 0`` splits into +/- with half its mass each (stochastic
    rounding is sign-symmetric).
    """
    p = np.asarray(level_probs, np.float64)
    L = p.shape[0]
    joint = np.empty(2 * L - 1, np.float64)
    joint[L - 1] = p[0]
    for j in range(1, L):
        joint[L - 1 + j] = joint[L - 1 - j] = p[j] / 2.0
    return joint


def canonical_code(lengths: Sequence[int]) -> np.ndarray:
    """Canonical prefix codewords from code lengths, bit-reversed for an
    LSB-first wire.

    Symbols are ranked by ``(length, symbol)`` and given consecutive
    MSB-first canonical values; each value is then bit-reversed within
    its length, so a packer that emits codeword bit 0 first transmits the
    canonical code MSB-first on the wire (the DEFLATE trick).
    """
    lengths = np.asarray(lengths, np.int64)
    S = lengths.shape[0]
    order = sorted(range(S), key=lambda s: (lengths[s], s))
    codes = np.zeros(S, np.uint64)
    code = 0
    prev = int(lengths[order[0]])
    for s in order:
        code <<= int(lengths[s]) - prev
        prev = int(lengths[s])
        rev = 0
        for b in range(prev):  # bit-reverse within the code length
            rev = (rev << 1) | ((code >> b) & 1)
        codes[s] = rev
        code += 1
    return codes.astype(np.uint32)


def entropy_table(level_probs: Sequence[float] | None,
                  num_levels: int) -> tuple[tuple, tuple]:
    """(lengths, wire codewords) for the signed-symbol alphabet, as int
    tuples (static codec configuration).

    ``level_probs=None`` builds the cold-start table from uniform joint
    occupancies (codeword lengths ~ the fixed wire width), so an
    ``EntropyCodec`` is decodable before any statistics exist.  A table
    whose longest code would exceed ``MAX_CODE_BITS`` falls back to the
    fixed-width (still prefix-free) code.
    """
    S = 2 * num_levels - 1
    if level_probs is None:
        joint = np.full(S, 1.0 / S, np.float64)
    else:
        p = np.asarray(level_probs, np.float64)
        if p.shape[0] != num_levels:
            raise ValueError(
                f"level_probs has {p.shape[0]} levels, codec has "
                f"{num_levels}")
        joint = signed_symbol_probabilities(p)
    joint = np.clip(joint, _PROB_FLOOR, None)
    joint = joint / joint.sum()
    lengths = huffman_code_lengths(joint)
    if int(lengths.max()) > MAX_CODE_BITS:
        lengths = np.full(S, wire_bits_for(num_levels), np.int64)
    codes = canonical_code(lengths)
    return (tuple(int(x) for x in lengths),
            tuple(int(x) for x in codes))


def code_length_bound(levels: torch.Tensor, stats: TruncNormStats, d: int,
                      *, q: float = 2.0, norm_bits: int = 32) -> float:
    """Thm 3 upper bound: b + n_{l1,d} + d (H(L) + 1)."""
    H = float(entropy_bits(level_probabilities(levels, stats)))
    l1 = float(levels[1]) if levels.shape[0] > 1 else 1.0
    n_l1_d = min(l1 ** (-q) + d ** (1.0 - 1.0 / q) / l1, float(d))
    return norm_bits + n_l1_d + d * (H + 1.0)
