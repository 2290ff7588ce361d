"""Quantized gradient synchronization (Algorithm 1, lines 2-9).

The M workers' local gradients arrive stacked as one (M, d) tensor and
what travels between them is a ``core.codec.WirePayload``: packed level
symbols plus packed bucket norms, never dequantized floats.  This module
sequences ENCODE -> collective -> DECODE -> average over a transport.

Wire modes
----------
``all_gather``  Every worker ENCODEs its own gradient and the packed
    payloads are all-gathered.  One decode over the M gathered streams
    and one mean give the aggregate, identical for every worker (the
    paper's broadcast-all scheme, Sec. 5).
``fp32``        Plain mean (SuperSGD / debugging baseline).

``gather_stats`` is the sufficient-statistics path (Algorithm 1, line 4):
one fused ``bucket_stats`` sweep per worker, strided subsampling to
``max_stat_components`` and a merge of the M workers' mixtures.
``maybe_update_levels`` runs it, and the level update, on update steps
only.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import torch

from repro_torch.core.codec import WirePayload, codec_for_scheme
from repro_torch.core.schemes import QuantScheme, SchemeState
from repro_torch.core.stats import (
    TruncNormStats, merge_stats, stats_from_moments)
from repro_torch.kernels import ops
from repro_torch.timing import NO_CLOCK
from .transport import StackedTransport


class SyncMetrics(NamedTuple):
    """Per-step wire accounting, split by direction as in the reference.

    ``quant_error`` holds each worker's ||Q(g_w) - g_w||^2, shape (M,).
    """

    comm_bits_per_coord: float
    quant_error: torch.Tensor
    reduce_bits_per_coord: float
    broadcast_bits_per_coord: float
    entropy_bits_per_coord: torch.Tensor


def _allreduce_all_gather(flats, codec, levels, transport, u, generator,
                          clock):
    M, d = flats.shape
    plan = codec.plan(d)
    payloads = []
    for w in range(M):
        vb = codec.bucketize(flats[w], plan)
        payloads.append(codec.encode(
            vb, levels, u=None if u is None else u[w],
            generator=generator, clock=clock))
        del vb
    gathered = WirePayload(
        words=transport.all_gather([p.words for p in payloads]),
        norm_words=transport.all_gather([p.norm_words for p in payloads]))
    per_worker = codec.decode(gathered, levels, plan, clock=clock)  # (M, n)
    out = transport.mean_workers(per_worker)[:d]
    qerr = torch.stack([torch.sum((per_worker[w, :d] - flats[w]) ** 2)
                        for w in range(M)])
    clock.mark("decode")
    bits = plan.bits_per_coord
    # the single gather is the broadcast-all hop (paper Sec. 5)
    return out, per_worker[:, :d], (bits, qerr, 0.0, bits)


def quantized_allreduce(
    flats: torch.Tensor,
    scheme: QuantScheme,
    state: SchemeState,
    *,
    mode: str = "all_gather",
    u: Sequence[torch.Tensor] | None = None,
    generator: torch.Generator | None = None,
    return_own: bool = False,
    clock=NO_CLOCK,
) -> tuple:
    """ENCODE -> collective -> DECODE -> average.

    Args:
      flats: (M, d) local gradients, worker w's at row w.
      scheme / state: quantization method and its adaptive state (levels).
      mode: 'fp32' | 'all_gather'.  The wire is the scheme's uniform
        codec, moved over a ``StackedTransport`` of the M workers.
      u: per-worker (nb, bucket_size) float32 uniforms, u[w] for worker
        w, as the tests feed the reference's draws; when None every
        worker draws its own from ``generator``.
      return_own: also return each worker's own lossy round trip
        Q(flats[w]) as an (M, d) tensor.
      clock: stage clock (``mark(stage)``) for per-stage timing.

    Returns (aggregate mean (d,), SyncMetrics), or (aggregate, own,
    SyncMetrics) with ``return_own``.
    """
    M = flats.shape[0]
    transport = StackedTransport(M)
    if mode == "fp32" or not scheme.quantized:
        out = transport.mean_psum(flats)
        m = SyncMetrics(32.0, torch.zeros(M, device=flats.device), 32.0,
                        0.0, torch.tensor(32.0, device=flats.device))
        return (out, flats, m) if return_own else (out, m)
    if mode != "all_gather":
        raise ValueError(f"unknown or unported sync mode {mode!r}")
    out, own, (bits, qerr, red, bc) = _allreduce_all_gather(
        flats, codec_for_scheme(scheme), state.levels, transport, u,
        generator, clock)
    m = SyncMetrics(bits, qerr, red, bc, state.entropy_bits)
    return (out, own, m) if return_own else (out, m)


def gather_stats(flats: torch.Tensor, scheme: QuantScheme) -> TruncNormStats:
    """Sufficient statistics of every worker's gradient, merged.

    One fused ``bucket_stats`` pass per worker gives per-bucket (norm,
    mean_r, var_r); each worker keeps ``max_stat_components`` components
    and the M mixtures are merged.
    """
    M, d = flats.shape
    codec = codec_for_scheme(scheme)
    plan = codec.plan(d)
    # keep only fully populated buckets: alignment padding is all-zero,
    # and a trailing partial bucket's zeros would bias its (mu, sigma)
    # toward 0; drop it unless it is the only bucket
    nb_valid = max(d // scheme.bucket_size, 1)
    per_worker = []
    for w in range(M):
        norms, mu, var = ops.bucket_stats_op(
            codec.bucketize(flats[w], plan), norm_type=scheme.norm_type)
        per_worker.append(stats_from_moments(
            mu[:nb_valid], var[:nb_valid], norms[:nb_valid],
            weighted=scheme.weighted_stats,
            max_components=scheme.max_stat_components))
    return merge_stats(TruncNormStats(*(torch.stack(f)
                                        for f in zip(*per_worker))))


def maybe_update_levels(flats: torch.Tensor, scheme: QuantScheme,
                        state: SchemeState, do_update: bool, *,
                        clock=NO_CLOCK) -> SchemeState:
    """Run the scheme's level adaptation iff ``do_update``; non-update
    steps pay nothing."""
    if not (scheme.adaptive and do_update):
        return state
    state = scheme.update_state(state, gather_stats(flats, scheme))
    clock.mark("stats")
    return state
