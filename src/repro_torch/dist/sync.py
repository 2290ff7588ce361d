"""Quantized gradient synchronization (Algorithm 1, lines 2-9).

The gradients of the workers a process holds (the transport's
``local_workers()``: all M on the stacked transport, one on a process
group) arrive as one (L, d) tensor, and what travels between workers is
a ``core.codec.WirePayload``: packed level symbols plus packed bucket
norms, never dequantized floats.  This module sequences ENCODE ->
collective -> DECODE -> average over a transport; every process ends
with the same aggregate, and with all M workers' metrics.

Wire modes
----------
``all_gather``  Every worker ENCODEs its own gradient and the packed
    payloads are all-gathered.  One fused decode+average pass over the
    M gathered streams (``codec.decode_mean``) gives the aggregate,
    identical for every worker (the paper's broadcast-all scheme, Sec.
    5).
``two_phase``   The reduce direction moves the codec's *sharded* payload
    by an all-to-all (each worker ships each peer only that peer's
    shard), each worker averages its shard and re-quantizes it on a
    fixed 8-bit uniform/L-inf grid, and the packed shards are
    all-gathered: ~(b + 8/M + 9) bits/coord instead of M*b.
``fp32``        Plain mean (SuperSGD / debugging baseline).

With an integrity plan every decode is checked: corrupt buckets are
excluded from the mean (``mean_workers_bucketed``) and corrupt phase-2
buckets zero-fill.  ``compressed_allreduce`` wraps the wire modes in the
``repro_torch.compress`` hook: residual injection before ENCODE, residual
update from each worker's own decode after DECODE.

Every worker holds the same aggregate, so a process decodes it once;
each local worker's own round trip Q(g_w) is decoded worker by worker
(from its row of the gathered codes, or with integrity words from its
local payload) and handed to ``on_own(i, own)`` (i its local index), so
that neither an (M, d) float32 of decoded streams nor an (L, d) tensor
of own round trips is held beside the aggregate.  The transport says
how the streams are averaged (``mean_weights``); the codec decodes and
averages them.  The collectives are booked to the clock's
``collective`` stage, the fp32 wire's mean too.

While a step is being recorded (``repro_torch.timing``) the wire opens
its spans: ``encode`` a worker (the codec's ``quantize``, ``checksum``
and ``pack`` inside), ``collective`` with the ``bytes`` and ``calls`` it
hands the transport (tensors of one dimension or more, as the
benchmark's counting transport counts them), ``decode`` (the codec's
per-stream ``unpack`` and ``checksum`` inside), ``requant``,
``compress``, and on update steps ``stats`` and ``fit``.

``gather_stats`` is the sufficient-statistics path (Algorithm 1, line 4):
one fused ``bucket_stats`` sweep per local worker, strided subsampling to
``max_stat_components``, a gather and a merge of the M workers'
mixtures.
``maybe_update_levels`` runs it, and the level update, on update steps
only.
"""
from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import torch

from repro_torch import timing
from repro_torch.core.codec import (
    GradientCodec, WirePayload, codec_for_scheme, requant_codec)
from repro_torch.core.levels import uniform_levels
from repro_torch.core.schemes import QuantScheme, SchemeState
from repro_torch.core.stats import (
    TruncNormStats, merge_stats, stats_from_moments)
from repro_torch.kernels import ops
from repro_torch.numerics import reciprocal
from repro_torch.timing import NO_CLOCK, Renamed
from .transport import StackedTransport, make_transport

# Phase-2 grid of the two_phase mode: 8-bit uniform levels under L-inf
# bucket normalization (QSGDinf at 8 bits), fine enough that the second
# rounding does not forfeit the 1/M variance averaging.
TWO_PHASE_BITS = 8

Uniforms = Sequence[torch.Tensor] | None


class SyncMetrics(NamedTuple):
    """Per-step wire accounting, split by direction as in the reference.

    Per-worker fields are (M,) tensors, entry w being what the
    reference's worker w reports: ``quant_error`` ||Q(g_w) - g_w||^2,
    ``residual_norm`` the error-feedback residual's norm after this step
    (0 for stateless algorithms), ``corrupt_fraction`` the share of the
    (worker, bucket) wire slots worker w decoded that failed an integrity
    check and ``excluded_workers`` how many workers' whole payloads did
    (both 0 without an integrity plan).  ``kept_fraction`` is the share
    of coordinates on the wire (< 1 only for the sparse codec).  The
    bits/coord fields are measured for a variable-volume codec (the
    entropy-coded wire: what worker 0's length headers say it ships) and
    the plan's otherwise; ``worker_bits_per_coord`` holds that number for
    every worker's own payload (the gather of all_gather, the reduce
    direction of two_phase), as the simulator's cost model bills it.
    """

    comm_bits_per_coord: float
    quant_error: torch.Tensor
    reduce_bits_per_coord: float
    broadcast_bits_per_coord: float
    entropy_bits_per_coord: torch.Tensor
    residual_norm: torch.Tensor | None = None
    kept_fraction: float = 1.0
    corrupt_fraction: torch.Tensor | None = None
    excluded_workers: torch.Tensor | None = None
    worker_bits_per_coord: tuple = ()


def _generator_of(generator, i):
    """Local worker i's generator: its own where ``generator`` is a
    sequence of one a local worker, else the one shared generator."""
    if isinstance(generator, (list, tuple)):
        return generator[i]
    return generator


def encode_workers(flats, codec, levels, plan, u=None, generator=None,
                   clock=NO_CLOCK, workers=None) -> list[WirePayload]:
    """Every local worker's payload of its row of ``flats``, local worker
    i rounding with ``u[i]`` or else drawing from its generator (see
    ``_generator_of``; a shared one is drawn in local order).  ``workers``
    names the rows' workers in the ``encode`` spans (their local indices
    by default)."""
    payloads = []
    for i in range(flats.shape[0]):
        with timing.span("encode", worker=i if workers is None
                         else workers[i]):
            vb = codec.bucketize(flats[i], plan)
            payloads.append(codec.encode(
                vb, levels, plan=plan, u=None if u is None else u[i],
                generator=_generator_of(generator, i), clock=clock))
            del vb
    return payloads


def payload_bits_per_coord(codec, payloads, plan) -> tuple:
    """Each worker's own payload's bits/coord (read from its length
    headers for a variable-volume codec)."""
    if not plan.variable:
        return (plan.bits_per_coord,) * len(payloads)
    return tuple(codec.measured_bits_per_coord(p, plan) for p in payloads)


def _all_workers(transport, local: torch.Tensor) -> torch.Tensor:
    """The local workers' (L,) values -> all M workers', in worker order
    (a float side band: ``FaultyTransport`` passes it un-faulted)."""
    return transport.all_gather(list(local))


def _all_bits(transport, codec, payloads, plan, device) -> tuple:
    """Every worker's own payload's bits/coord, whichever process holds
    it (float64 on the wire, so the Python floats come back exact)."""
    if not plan.variable:
        return (plan.bits_per_coord,) * transport.size()
    local = payload_bits_per_coord(codec, payloads, plan)
    return tuple(_all_workers(transport, torch.tensor(
        local, dtype=torch.float64, device=device)).tolist())


def _sq_err(own: torch.Tensor, row: torch.Tensor) -> torch.Tensor:
    """||own - row||^2 with one temporary: the difference, squared in
    place (the same values as ``((own - row) ** 2).sum()``)."""
    diff = own - row
    return torch.sum(diff.square_())


def moved(tensors) -> None:
    """Count one transport call, and the bytes of the ``tensors`` of one
    dimension or more handed to it, in the open ``collective`` span."""
    timing.count("calls")
    timing.count("bytes", sum(t.numel() * t.element_size() for t in tensors
                              if t.dim() >= 1))


def _gather(transport, payloads, collective: str, clock) -> WirePayload:
    move = getattr(transport, collective)
    words = [p.words for p in payloads]
    norm_words = [p.norm_words for p in payloads]
    with timing.span("collective"):
        moved(words)
        moved(norm_words)
        out = WirePayload(words=move(words), norm_words=move(norm_words))
    clock.mark("collective")
    return out


def _allreduce_all_gather(flats, codec, levels, transport, u, u2, generator,
                          on_own, clock):
    d = flats.shape[1]
    local = transport.local_workers()
    plan = codec.plan(d)
    payloads = encode_workers(flats, codec, levels, plan, u, generator, clock,
                              local)
    gathered = _gather(transport, payloads, "all_gather", clock)
    qerr = torch.empty(len(local), device=flats.device)
    # every worker decodes the same gathered rows: one verdict for all
    corrupt = torch.zeros(transport.size(), device=flats.device)
    excluded = torch.zeros(transport.size(), device=flats.device)
    with timing.span("decode"):
        # corrupt buckets leave the mean (with integrity words)
        dec = codec.decode_mean(gathered, levels, plan, transport,
                                checked=plan.integrity, clock=clock)
        del gathered
        out = dec.mean[:d]
        if plan.integrity:
            # the reference's mean(1 - valid): an exact count, times 1/n
            corrupt[:] = ((~dec.valid).float().sum()
                          * reciprocal(dec.valid.numel()))
            excluded[:] = (~dec.valid).all(dim=1).float().sum()
        for i, w in enumerate(local):
            # with integrity words each worker's own round trip comes from
            # its local payload, not its gathered row, so that wire
            # corruption cannot poison an error-feedback residual
            own = (codec.decode(payloads[i], levels, plan) if plan.integrity
                   else dec.row(w))[:d]
            qerr[i] = _sq_err(own, flats[i])
            on_own(i, own)
            del own
        del dec
    clock.mark("decode")
    # variable-volume codecs bill what each worker's headers say it ships
    bits = _all_bits(transport, codec, payloads, plan, flats.device)
    # the single gather is the broadcast-all hop (paper Sec. 5)
    return out, SyncMetrics(bits[0], _all_workers(transport, qerr), 0.0,
                            bits[0], None,
                            corrupt_fraction=corrupt,
                            excluded_workers=excluded,
                            worker_bits_per_coord=bits)


def _allreduce_two_phase(flats, codec, levels, transport, u, u2, generator,
                         on_own, clock):
    d = flats.shape[1]
    M, local = transport.size(), transport.local_workers()
    dev = flats.device
    plan = codec.plan(d, shards=M)
    snb, bs = plan.shard_nb, plan.bucket_size

    # ---- phase 1: quantized reduce-scatter (the scheme's grid) ----
    payloads = encode_workers(flats, codec, levels, plan, u, generator, clock,
                              local)
    if M == 1:  # an unsharded payload is 1-D; the wire still sees a row
        payloads = [WirePayload(p.words[None], p.norm_words[None])
                    for p in payloads]
    # [local receiver, sender]
    received = _gather(transport, payloads, "all_to_all", clock)
    codec2 = requant_codec(codec, TWO_PHASE_BITS)
    lv2 = uniform_levels(TWO_PHASE_BITS, device=dev)
    plan2 = codec2.plan_buckets(snb)
    bad1 = torch.zeros(len(local), device=dev)
    excluded = torch.zeros(len(local), device=dev)
    phase2 = []
    # each rank decodes, averages and re-quantizes its own shard
    for i, r in enumerate(local):
        mine = WirePayload(received.words[i], received.norm_words[i])
        with timing.span("decode", worker=r):
            dec = codec.decode_mean(mine, levels, plan, transport, shard=r,
                                    checked=plan.integrity, clock=clock)
            shard_mean = dec.mean
            if plan.integrity:
                bad1[i] = (~dec.valid).float().sum()
                excluded[i] = (~dec.valid).all(dim=1).float().sum()
            del dec
        clock.mark("decode")

        # ---- phase 2: re-quantize this rank's shard of the aggregate ----
        with timing.span("requant", worker=r):
            phase2.append(codec2.encode(
                shard_mean.view(snb, bs), lv2, plan=plan2,
                u=None if u2 is None else u2[i],
                generator=_generator_of(generator, i),
                clock=Renamed(clock, "requant")))
        del shard_mean
    del received
    g2 = _gather(transport, phase2, "all_gather", clock)
    # every worker decodes the same gathered bytes: decode them once
    with timing.span("decode"):
        if plan2.integrity:
            out, valid2 = codec2.decode_checked(g2, lv2, plan2, clock=clock)
            # phase 2 carries each shard once, with nothing to renormalize
            # over: a corrupt bucket zero-fills (masked_fill, not a
            # product, as it may decode to NaN)
            out.view(M, snb, bs).masked_fill_(~valid2[:, :, None], 0.0)
            bad2 = (~valid2).float().sum()
            corrupt = ((_all_workers(transport, bad1) + bad2)
                       * reciprocal(2 * M * snb))
        else:
            out = codec2.decode(g2, lv2, plan2, clock=clock)
            corrupt = torch.zeros(M, device=dev)
        del g2
        out = out.reshape(-1)[:d]

    # each worker's own phase-1 payload, decoded shard by shard
    qerr = torch.empty(len(local), device=dev)
    for i, w in enumerate(local):
        with timing.span("decode", worker=w):
            own = codec.decode(payloads[i], levels, plan,
                               clock=clock).reshape(-1)[:d]
            qerr[i] = _sq_err(own, flats[i])
            on_own(i, own)
            del own
    clock.mark("decode")
    bits_reduce = _all_bits(transport, codec, payloads, plan, dev)
    bits_bcast = 32.0 * (plan2.code_words + plan2.norm_words) / d
    return out, SyncMetrics(bits_reduce[0] + bits_bcast,
                            _all_workers(transport, qerr),
                            bits_reduce[0], bits_bcast, None,
                            corrupt_fraction=corrupt,
                            excluded_workers=_all_workers(transport,
                                                          excluded),
                            worker_bits_per_coord=bits_reduce)


_MODES = {"all_gather": _allreduce_all_gather,
          "two_phase": _allreduce_two_phase}


def _transport_for(flats, transport):
    """``transport``, or the stacked transport of ``flats``'s M rows;
    ``flats`` must hold one row a local worker."""
    if transport is None:
        return make_transport(flats.shape[0])
    local = transport.local_workers()
    if len(local) != flats.shape[0]:
        raise ValueError(f"transport holding {len(local)} of "
                         f"{transport.size()} workers for "
                         f"{flats.shape[0]} gradient rows")
    return transport


def _allreduce(flats, scheme, state, mode, transport, codec, u, u2,
               generator, on_own, clock):
    """Every sync mode: (aggregate (d,), SyncMetrics)."""
    M = transport.size()
    if mode == "fp32" or not scheme.quantized:
        for i in range(flats.shape[0]):  # lossless: own round trip = input
            on_own(i, flats[i])
        with timing.span("collective"):
            moved([flats])
            out = transport.mean_psum(flats)
        clock.mark("collective")
        return out, _fp32_metrics(M, flats.device)
    if mode not in _MODES:
        raise ValueError(f"unknown sync mode {mode!r}; known: "
                         f"('fp32', {', '.join(map(repr, _MODES))})")
    if codec is None:
        codec = codec_for_scheme(scheme)
    out, m = _MODES[mode](flats, codec, state.levels, transport, u, u2,
                          generator, on_own, clock)
    return out, m._replace(entropy_bits_per_coord=state.entropy_bits,
                           residual_norm=torch.zeros(M, device=flats.device))


def _fp32_metrics(M, dev) -> SyncMetrics:
    zeros = torch.zeros(M, device=dev)
    return SyncMetrics(32.0, zeros, 32.0, 0.0, torch.tensor(32.0, device=dev),
                       residual_norm=zeros, corrupt_fraction=zeros,
                       excluded_workers=zeros)


def quantized_allreduce(
    flats: torch.Tensor,
    scheme: QuantScheme,
    state: SchemeState,
    *,
    mode: str = "all_gather",
    transport: StackedTransport | None = None,
    codec: GradientCodec | None = None,
    u: Uniforms = None,
    u2: Uniforms = None,
    generator: torch.Generator | Sequence[torch.Generator] | None = None,
    return_own: bool = False,
    clock=NO_CLOCK,
) -> tuple:
    """ENCODE -> collective -> DECODE -> average.

    Args:
      flats: (L, d) gradients of the transport's L local workers, local
        worker i's (global worker ``transport.local_workers()[i]``) at
        row i; all M rows on the default stacked transport.
      scheme / state: quantization method and its adaptive state (levels).
      mode: 'fp32' | 'all_gather' | 'two_phase'.
      transport: the collective transport (a ``StackedTransport`` of the
        M workers by default; ``MaskedTransport`` to drop workers,
        ``dist.faults.FaultyTransport`` to corrupt the wire,
        ``ProcessGroupTransport`` for one worker a process).
      codec: the wire codec (the scheme's uniform codec by default).
      u: per-worker float32 uniforms of the phase-1 rounding, u[i] for
        local worker i, shaped like the codec's encode draws them (the
        tests feed the reference's draws); when None every worker draws
        its own from ``generator``.
      u2: per-rank (shard_nb, bucket_size) uniforms of the two_phase
        re-quantization, u2[i] for local worker i's rank; drawn from
        ``generator`` when None.
      generator: one generator, drawn in local worker order, or a
        sequence of one a local worker.
      return_own: also return each local worker's own lossy round trip
        Q(flats[i]) as an (L, d) tensor.
      clock: stage clock (``mark(stage)``) for per-stage timing.

    Returns (aggregate mean (d,), SyncMetrics), or (aggregate, own,
    SyncMetrics) with ``return_own``.  Every process holds the same
    aggregate, and the per-worker metrics of all M workers.
    """
    transport = _transport_for(flats, transport)
    own = torch.empty_like(flats) if return_own else None

    def keep(w, row):
        if own is not None:
            own[w] = row

    out, m = _allreduce(flats, scheme, state, mode, transport, codec, u, u2,
                        generator, keep, clock)
    return (out, own, m) if return_own else (out, m)


def compressed_allreduce(
    flats: torch.Tensor,
    scheme: QuantScheme,
    state: SchemeState,
    algorithm,
    comp_state,
    *,
    mode: str = "all_gather",
    transport: StackedTransport | None = None,
    u: Uniforms = None,
    u2: Uniforms = None,
    generator: torch.Generator | Sequence[torch.Generator] | None = None,
    clock=NO_CLOCK,
) -> tuple:
    """The ``repro_torch.compress`` algorithm hook around ENCODE/DECODE.

    ``algorithm.prepare`` injects the residual into ``flats`` IN PLACE
    (so the (L, d) local gradient rows hold what is encoded), the wire
    runs on the algorithm's codec, and ``algorithm.feedback`` updates
    local worker i's residual row from its own decode as soon as that
    decode exists.  With the stateless ``plain`` algorithm this is
    ``quantized_allreduce`` on the same codec, bit for bit (``comp_state``
    may then be None).

    Returns (aggregate mean, new comp_state, SyncMetrics) with
    ``residual_norm`` (all M workers') and ``kept_fraction`` filled in.
    """
    transport = _transport_for(flats, transport)
    # the stateless passthrough has no stage of its own
    hook_clock = clock if algorithm.stateful else NO_CLOCK

    def hook_span(**kw):
        return (timing.span("compress", **kw) if algorithm.stateful
                else contextlib.nullcontext())

    with hook_span():
        inp = algorithm.prepare(flats, comp_state)
    hook_clock.mark("compress")

    def feedback(w, own):
        hook_clock.mark("decode")
        with hook_span(worker=transport.local_workers()[w]):
            algorithm.feedback(comp_state, w, inp[w], own)
        hook_clock.mark("compress")

    out, m = _allreduce(inp, scheme, state, mode, transport, algorithm.codec,
                        u, u2, generator, feedback, clock)
    new_state = algorithm.advance(comp_state)
    m = m._replace(kept_fraction=algorithm.kept_fraction)
    if algorithm.stateful:
        with hook_span():
            m = m._replace(residual_norm=_all_workers(
                transport, new_state.residual_norm))
        hook_clock.mark("compress")
    return out, new_state, m


def gather_stats(flats: torch.Tensor, scheme: QuantScheme,
                 transport: StackedTransport | None = None
                 ) -> TruncNormStats:
    """Sufficient statistics of every worker's gradient, merged.

    One fused ``bucket_stats`` pass per local worker gives per-bucket
    (norm, mean_r, var_r); each worker keeps ``max_stat_components``
    components, and the M mixtures, gathered in worker order, are merged
    (the reference's ``merge_stats`` over the data axes).
    """
    transport = _transport_for(flats, transport)
    d = flats.shape[1]
    codec = codec_for_scheme(scheme)
    plan = codec.plan(d)
    # keep only fully populated buckets: alignment padding is all-zero,
    # and a trailing partial bucket's zeros would bias its (mu, sigma)
    # toward 0; drop it unless it is the only bucket
    nb_valid = max(d // scheme.bucket_size, 1)
    per_worker = []
    for row in flats:
        norms, mu, var = ops.bucket_stats_op(
            codec.bucketize(row, plan), norm_type=scheme.norm_type)
        per_worker.append(stats_from_moments(
            mu[:nb_valid], var[:nb_valid], norms[:nb_valid],
            weighted=scheme.weighted_stats,
            max_components=scheme.max_stat_components))
    with timing.span("collective"):
        fields = []
        for f in zip(*per_worker):
            moved(f)
            fields.append(transport.all_gather(list(f)))
    return merge_stats(TruncNormStats(*fields))


def maybe_update_levels(flats: torch.Tensor, scheme: QuantScheme,
                        state: SchemeState, do_update: bool, *,
                        transport: StackedTransport | None = None,
                        clock=NO_CLOCK) -> SchemeState:
    """Run the scheme's level adaptation iff ``do_update``; non-update
    steps pay nothing."""
    if not (scheme.adaptive and do_update):
        return state
    with timing.span("stats"):
        stats = gather_stats(flats, scheme, transport)
    with timing.span("fit"):
        state = scheme.update_state(state, stats)
    clock.mark("stats")
    return state
