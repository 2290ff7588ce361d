"""Flat-parameter FSDP substrate, the reference's ``dist/fsdp.py``.

The parameters of one layer slot are ONE flat, zero-padded vector sharded
over the M data-parallel workers.  The forward materializes a slot by an
all-gather of the shards; the backward of that gather is a *quantized
reduce-scatter*: each worker ENCODEs its cotangent through the wire codec
and ships each peer only that peer's shard as a packed ``WirePayload``,
so FSDP moves ``b``-bit gradients where it would move float32.

Layout (``padded_flat_len`` / ``chunk_plan``)::

  padded length  Lp = nb_p * bucket_size,   nb_p % (M * k) == 0

so every shard holds whole buckets and the backward runs in ``k`` rounds:
round c covers buckets ``[c*ppr, (c+1)*ppr)`` of every shard.  A codec
that is not ``chunkable`` (mixed widths) runs in one round.  Zero padding
is a fixed point of ENCODE/DECODE and of the optimizers, so padded
parameters never move.

Two forms of the gather share this module (``make_gather``):

* a transport that holds one worker (a ``ProcessGroupTransport`` rank, or
  one stacked worker): ``FsdpGather``, a ``torch.autograd.Function``
  whose forward all-gathers the shards and whose backward runs
  ``_quantized_reduce_scatter`` at once, as the reference's
  ``custom_vjp`` does;
* M > 1 workers stacked in one process, whose backwards run one after
  another: the forward is the concatenation of the M shards (a view) and
  the backward leaves each worker's cotangent in its gradient row, so
  that the caller runs ``_quantized_reduce_scatter`` over the M stacked
  rows once every worker's backward has run.  Both forms give every
  worker the same bytes.

Randomness follows the reference's keys.  A key is any object with
``fold(i)`` (the counterpart of ``jax.random.fold_in``) and ``uniform(
shape, device)`` (float32 uniforms); ``SeedKey`` derives integer seeds
and draws with a ``torch.Generator``, and a test may pass a key that
replays ``jax.random``.  The reduce-scatter folds the worker's index into
its key, then the round's index, as the reference does.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch

from repro_torch import timing
from repro_torch.core.codec import GradientCodec, WirePayload, codec_for_scheme
from repro_torch.core.schemes import QuantScheme
from .sync import moved
from .transport import StackedTransport

# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


class SeedKey:
    """An integer key: ``fold(i)`` mixes ``i`` into a new 63-bit seed,
    ``uniform`` draws from a ``torch.Generator`` seeded with it, so that
    one key gives the same draws in every process (on one device type:
    the CPU's and CUDA's generators draw different streams)."""

    def __init__(self, seed: int):
        self.seed = int(seed)

    def fold(self, i: int) -> "SeedKey":
        ss = np.random.SeedSequence([self.seed, int(i)])
        return SeedKey(int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1)))

    def uniform(self, shape, device) -> torch.Tensor:
        if torch.device(device).type == "meta":   # shapes only, no generator
            return torch.empty(shape, dtype=torch.float32, device=device)
        gen = torch.Generator(device=device).manual_seed(self.seed)
        return torch.rand(shape, generator=gen, dtype=torch.float32,
                          device=device)

    def __repr__(self) -> str:
        return f"SeedKey({self.seed})"


# ---------------------------------------------------------------------------
# flatten metadata
# ---------------------------------------------------------------------------

def flatten_meta(specs: dict, prefix: tuple = ()) -> list:
    """Param-spec tree (leaves ``(shape, init_code)``) -> ``[(path, shape,
    init_code)]`` in sorted-name order at every level."""
    meta = []
    for name in sorted(specs):
        sub = specs[name]
        if isinstance(sub, dict):
            meta.extend(flatten_meta(sub, prefix + (name,)))
        else:
            shape, code = sub
            meta.append((prefix + (name,), tuple(shape), code))
    return meta


def flat_size(meta: list) -> int:
    return sum(math.prod(shape) for _, shape, _ in meta)


def chunk_plan(n: int, bucket_size: int, M: int) -> tuple[int, int]:
    """(k, nb_padded) for an n-element flat vector on M workers: the
    deepest k in {8, 4, 2, 1} that gives every worker at least one bucket
    a round, the bucket count padded to a multiple of ``M * k``."""
    nb = -(-n // bucket_size)
    k = 1
    for cand in (8, 4, 2):
        if cand * M <= nb:
            k = cand
            break
    group = M * k
    return k, -(-nb // group) * group


def padded_flat_len(meta: list, bucket_size: int, world: int,
                    shards: int | None = None) -> int:
    """Padded flat length: bucket-, round- and shard-divisible."""
    m = world if shards is None else math.lcm(world, shards)
    _, nb_p = chunk_plan(flat_size(meta), bucket_size, m)
    return nb_p * bucket_size


def unflatten(flat: torch.Tensor, meta: list, dtype) -> dict:
    """Flat (padded) vector -> nested dict of ``meta``'s leaves, each a
    view of ``flat`` cast to ``dtype``."""
    tree: dict = {}
    off = 0
    for path, shape, _ in meta:
        size = math.prod(shape)
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = flat[off:off + size].view(shape).to(dtype)
        off += size
    return tree


# ---------------------------------------------------------------------------
# quantized reduce-scatter (the gather's backward)
# ---------------------------------------------------------------------------

def _rounds_for(shard_nb: int) -> int:
    """The round count of a shard of ``shard_nb`` buckets, re-derived from
    the padded shape as the reference does."""
    for cand in (8, 4, 2):
        if shard_nb % cand == 0 and shard_nb > cand:
            return cand
    return 1


def _quantized_reduce_scatter(rows: torch.Tensor, levels: torch.Tensor,
                              keys: Sequence, *, transport: StackedTransport,
                              codec: GradientCodec,
                              residual: torch.Tensor | None = None,
                              u: Sequence[Sequence[torch.Tensor]] | None
                              = None):
    """(L, Lp) cotangents of the transport's L local workers -> (L, Lp/M),
    local worker i's shard of the worker MEAN.

    Each round encodes worker i's slice ``[c*ppr, (c+1)*ppr)`` of every
    shard as one (M*ppr, bs) payload planned ``plan_buckets(M*ppr,
    shards=M)``, with the uniforms ``u[i][c]`` or else
    ``keys[i].fold(rank).fold(c).uniform(...)``; the all_to_all moves
    segment j to worker j, which decodes the M streams of its segment and
    takes their mean (``codec.decode_mean``).

    ``residual`` (L, Lp) enables error feedback: the residual is added to
    the cotangent before ENCODE and the new residual ``inp - Q(inp)`` is
    decoded from the worker's own payloads (no extra wire bytes).
    Returns ``(shard_mean, new_residual)`` in that case.
    """
    M = transport.size()
    L, Lp = rows.shape
    if residual is not None:
        rows = rows + residual
    bs = codec.bucket_size
    nb = Lp // bs
    shard_nb = nb // M
    k = _rounds_for(shard_nb) if codec.chunkable else 1
    ppr = shard_nb // k
    gb = rows.view(L, M, shard_nb, bs)
    dev = rows.device
    plan = codec.plan_buckets(M * ppr, shards=M)
    shape = codec.rounding_shape(M * ppr)
    local = transport.local_workers()
    round_keys = None if u is not None else [
        keys[i].fold(local[i]) for i in range(L)]
    pieces = [[] for _ in range(L)]
    own = None if residual is None else torch.empty(
        (L, M, shard_nb, bs), dtype=torch.float32, device=dev)
    for c in range(k):
        payloads = []
        for i in range(L):
            vb = gb[i, :, c * ppr:(c + 1) * ppr].reshape(M * ppr, bs)
            ui = (u[i][c] if u is not None
                  else round_keys[i].fold(c).uniform(shape, dev))
            p = codec.encode(vb.float(), levels, plan=plan, u=ui)
            del ui
            if M == 1:  # an unsharded payload is 1-D; the wire sees a row
                p = WirePayload(p.words[None], p.norm_words[None])
            if own is not None:
                # segment j of the own payload is shard j's round-c slice
                own[i, :, c * ppr:(c + 1) * ppr] = codec.decode(
                    p, levels, plan, shard=None).view(M, ppr, bs)
            payloads.append(p)
        words = [p.words for p in payloads]
        norm_words = [p.norm_words for p in payloads]
        with timing.span("collective"):
            moved(words)
            moved(norm_words)
            received = WirePayload(transport.all_to_all(words),
                                   transport.all_to_all(norm_words))
        del payloads
        for i in range(L):
            mine = WirePayload(received.words[i], received.norm_words[i])
            # the reference's decode of the M streams and their mean, in one
            # dequantize_mean where the codec fuses them
            pieces[i].append(codec.decode_mean(
                mine, levels, plan, transport, shard=local[i]).mean)
        del received
    shard_mean = torch.stack([torch.cat(p) for p in pieces])
    if residual is None:
        return shard_mean
    return shard_mean, rows - own.view(L, Lp)


def reduce_scatter(rows: torch.Tensor, levels: torch.Tensor, keys, *,
                   transport: StackedTransport, codec: GradientCodec,
                   quantized: bool, residual: torch.Tensor | None = None):
    """The gather's backward over (L, Lp) local rows -> (L, Lp/M) shards
    of the worker mean: ``_quantized_reduce_scatter`` where ``quantized``,
    else the float32 mean (the reference's ``psum_scatter / M``), into
    which a ``residual`` flushes (its new value zeros).  With a
    ``residual``, returns ``(shard_mean, new_residual)``."""
    if quantized:
        return _quantized_reduce_scatter(rows, levels, keys,
                                         transport=transport, codec=codec,
                                         residual=residual)
    inp = (rows if residual is None else rows + residual).float()
    with timing.span("collective"):
        moved([inp])
        out = transport.reduce_scatter_mean(inp)
    return out if residual is None else (out, torch.zeros_like(residual))


# ---------------------------------------------------------------------------
# the gather
# ---------------------------------------------------------------------------

def _all_gather_shard(shard: torch.Tensor, transport) -> torch.Tensor:
    """This worker's (1, Lp/M) shard -> the (Lp,) vector of all shards."""
    with timing.span("collective"):
        moved([shard[0]])
        return transport.all_gather([shard[0]]).reshape(-1)


class FsdpGather(torch.autograd.Function):
    """All-gather forward, reduce-scatter backward, for a transport that
    holds one worker.  ``spec`` = (transport, codec, quantized); the
    residual of error feedback, if any, comes back as its gradient."""

    @staticmethod
    def forward(ctx, shard, levels, residual, key, spec):
        ctx.key, ctx.spec = key, spec
        ctx.levels, ctx.residual = levels, residual
        ctx.shard_dtype = shard.dtype
        return _all_gather_shard(shard, spec[0])

    @staticmethod
    def backward(ctx, g):
        transport, codec, quantized = ctx.spec
        r = ctx.residual
        out = reduce_scatter(g[None], ctx.levels, [ctx.key],
                             transport=transport, codec=codec,
                             quantized=quantized,
                             residual=None if r is None else r[None])
        new_r = None
        if r is not None:
            out, new_r = out[0], out[1][0]
        return out.to(ctx.shard_dtype), None, new_r, None, None


def make_gather(scheme: QuantScheme, fsdp_sync: str = "quantized", *,
                transport: StackedTransport | None = None,
                codec: GradientCodec | None = None, algorithm=None):
    """``gather(shard, levels, key) -> full`` for one flat slot.

    ``shard`` holds the local workers' shards, (L, Lp/M).  Forward: the
    all-gather of the M shards, (Lp,).  Backward: the reduce-scatter of
    the cotangent to the worker MEAN, quantized (the codec's payload on
    the wire) when ``fsdp_sync == 'quantized'`` and the scheme quantizes,
    else the float32 mean.  ``codec`` defaults to the scheme's uniform
    codec.

    With one worker a process the backward runs the reduce-scatter (a
    collective: every rank runs its backward in the same order).  With
    M > 1 stacked workers the gather is a view of the M shards and the
    backward leaves the worker's cotangent as the shard's gradient, for
    the caller's ``_quantized_reduce_scatter`` over the stacked rows.

    ``algorithm`` (a stateful ``repro_torch.compress`` algorithm, error
    feedback) makes it ``gather(shard, levels, key, residual)``: the
    backward encodes ``cotangent + residual`` through the algorithm's
    codec and returns the new residual as the ``residual`` input's
    gradient (one worker a process only).  ``warmup_steps`` raises, as
    the reference's does: the gather has no step counter.
    """
    transport = transport or StackedTransport(1)
    quantized = fsdp_sync == "quantized" and scheme.quantized
    if algorithm is not None:
        codec = algorithm.codec
        if algorithm.stateful and algorithm.warmup_steps:
            raise ValueError(
                "warmup_steps is not supported on the gather-level EF "
                "path: the gather carries no step counter, so the gate "
                "cannot be evaluated here.  Gate the residual in the "
                "training loop instead (inject zeros until warmup ends).")
        if not algorithm.stateful:
            algorithm = None
    if codec is None:
        codec = codec_for_scheme(scheme)
    spec = (transport, codec, quantized)
    stacked = len(transport.local_workers()) > 1

    def gather(shard, levels, key):
        if stacked:
            return shard.reshape(-1)
        return FsdpGather.apply(shard, levels, None, key, spec)

    def gather_ef(shard, levels, key, residual):
        if stacked:
            raise NotImplementedError(
                "error feedback at the gather needs one worker a process; "
                "stacked workers run _quantized_reduce_scatter(residual=) "
                "over their rows")
        return FsdpGather.apply(shard, levels, residual, key, spec)

    return gather_ef if algorithm is not None else gather
