"""Aggregation topologies for the cluster simulator.

Three ways to turn M per-worker gradients into an aggregate, behind one
interface (``run_topology``), each the counterpart of the reference
package's topology of the same name:

``allreduce``     the production collective: ``dist.sync
    .quantized_allreduce`` on the stacked (M, d) rows, with a
    ``MaskedTransport`` when some workers are absent or down-weighted and
    a ``FaultyTransport`` when the fault model corrupts the wire.
``param_server``  every worker ENCODEs and ships its payload up; the
    server DECODEs the M streams and averages them in one pass
    (``codec.decode_mean``; a weighted sum under a mask), optionally
    RE-quantizes the aggregate on a fixed uniform L-inf grid of
    ``server_bits`` (int16 codes at 8 bits) and broadcasts one payload
    down.  With ``server_bits=None`` it broadcasts raw fp32, and
    a homogeneous cluster gets the allreduce's aggregate bit for bit: the
    same encodes, the same decode and the same mean.
``ring``          chunked ring allreduce with per-hop re-quantization: the
    gradient splits into M whole-bucket chunks, M-1 reduce hops pass
    accumulating partial sums around the ring, then M-1 gather hops
    circulate the finished chunks, every hop re-encoded in value space
    (``codec.requantize``), so the noise compounds with ring distance.

Randomness.  PyTorch cannot reproduce the reference's ``jax.random``
streams, so each topology takes its uniforms explicitly, or draws them
from ``generator`` when they are not given:

* allreduce: ``u``, u[w] worker w's rounding uniforms (and ``u2`` for
  the two_phase wire), as ``quantized_allreduce`` takes them;
* param_server: ``u`` as above, and ``u_server``, the (nb, bucket_size)
  uniforms of the downlink's re-quantization;
* ring: ``u_hops``, 2(M-1) hops (the reduce hops, then the gather hops)
  of M chunk-shaped tensors, u_hops[h][w] worker w's at hop h.  The own
  round trip re-uses hop 0's, as the reference re-uses hop 0's key, so
  that chunk w of it equals what worker w put on the wire.

Memory.  At full model width an (M, d) float32 tensor is as large as the
gradients, so the allreduce and param-server aggregates are one (d,)
tensor whose (M, d) view is expanded, the ring writes its per-worker
views into the buffer of its bucketized inputs once the reduce hops are
done with them, and each hop re-quantizes all M workers' chunks in one
call (a mixed-width codec, whose chunks have layouts of their own, one
call a worker).

Byte counts are host-side float32 numpy values computed as the reference
computes them, so the cost model sees the same numbers.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.codec import (
    GradientCodec, WirePayload, codec_for_scheme, requant_codec)
from repro_torch.core.levels import uniform_levels
from repro_torch.core.schemes import QuantScheme, SchemeState
from repro_torch.dist import sync
from repro_torch.dist.faults import FaultModel, faulty
from repro_torch.dist.transport import MaskedTransport, StackedTransport

# The name of the reference's logical-worker axis (a ``jax.vmap`` axis);
# the port stacks the workers along dimension 0 instead.
SIM_AXIS = "sim_workers"

TOPOLOGIES = ("allreduce", "param_server", "ring")

F32 = np.float32
Uniforms = Sequence[torch.Tensor] | None


class TopologyResult(NamedTuple):
    """What one synchronization round produced, per worker.

    ``aggregate`` is each worker's view of the aggregate: one (d,) tensor
    expanded to identical rows for allreduce and param_server, divergent
    rows for the ring (downstream copies of a chunk pass through more
    re-quantizations).  Byte counts feed the cluster cost model.
    """

    aggregate: torch.Tensor          # (M, d)
    sent_bytes: np.ndarray           # (M,) float32, sent by worker w
    recv_bytes: np.ndarray           # (M,) float32, received by worker w
    server_bytes: np.float32         # through the server (0 if none)
    hops: int                        # latency-serialized hops
    quant_error: torch.Tensor        # (M,) own injected quantization noise
    own: torch.Tensor | None = None  # (M, d) each worker's own round trip
    #   Q(input), the compression layer's feedback (want_own only)
    wire_bits_per_coord: np.ndarray = F32(0.0)  # (M,) float32: a worker's
    #   shipped wire bits per coordinate over both directions, measured
    #   for a variable-volume codec (the entropy wire), planned otherwise
    corrupt_fraction: float = 0.0    # share of (worker, bucket) wire slots
    #   that failed an integrity check (allreduce under wire faults)
    excluded_workers: float = 0.0    # workers whose whole payload failed


def _bits_of_workers(m: sync.SyncMetrics, M: int,
                     fallback: float) -> np.ndarray:
    """(M,) float32: each worker's payload bits/coord (``fallback`` each
    on the fp32 path, which encodes nothing)."""
    bits = m.worker_bits_per_coord or (fallback,) * M
    return np.asarray(bits, np.float32)


def _topo_allreduce(grads, scheme, state, active, *, mode, codec, want_own,
                    fault, fault_step, u, u2, generator):
    """``active=None`` keeps the plain ``mean(0)`` reduction; a mask
    switches to the renormalizing ``MaskedTransport``; wire faults wrap
    either in a ``FaultyTransport`` seeded from ``(fault.seed,
    fault_step)``."""
    M, d = grads.shape
    transport = (MaskedTransport(active) if active is not None
                 else StackedTransport(M))
    transport = faulty(transport, fault, fault_step)
    res = sync.quantized_allreduce(
        grads, scheme, state, mode=mode, transport=transport, codec=codec,
        u=u, u2=u2, generator=generator, return_own=want_own)
    out, own, m = res if want_own else (res[0], None, res[1])

    # bytes from the per-direction bits (per original coordinate; padding
    # is already in them), in float32 as the reference computes them
    scale = F32(d / 8.0)
    if mode == "two_phase":
        # phase 1's all-to-all ships each peer its shard; phase 2 gathers
        # the re-quantized shard payload from every worker
        p1 = _bits_of_workers(m, M, m.reduce_bits_per_coord) * scale
        p2 = np.full(M, m.broadcast_bits_per_coord, np.float32) * scale
        sent = F32((M - 1) / M) * p1 + F32(M - 1) * p2
        recv = F32((M - 1) / M) * p1 + (p2.sum(dtype=np.float32) - p2)
        hops = 2
        wire = (_bits_of_workers(m, M, m.reduce_bits_per_coord)
                + F32(m.broadcast_bits_per_coord))
    elif mode == "fp32" or not scheme.quantized:
        # costed as a bandwidth-optimal fp32 ring (2(M-1)/M 4d each way)
        sent = np.full(M, 2 * (M - 1) / M * 4.0 * d, np.float32)
        recv = sent
        hops = 2
        wire = np.full(M, m.comm_bits_per_coord, np.float32)
    else:
        # broadcast-all gather: each worker ships its payload to M-1 peers
        p = _bits_of_workers(m, M, m.broadcast_bits_per_coord) * scale
        sent = F32(M - 1) * p
        recv = p.sum(dtype=np.float32) - p
        hops = 1
        wire = _bits_of_workers(m, M, m.comm_bits_per_coord)
    return TopologyResult(
        out.expand(M, d), sent, recv, F32(0.0), hops, m.quant_error, own,
        wire, corrupt_fraction=float(m.corrupt_fraction[0]),
        excluded_workers=float(m.excluded_workers[0]))


def _topo_param_server(grads, scheme, state, active, *, server_bits, codec,
                       want_own, u, u_server, generator):
    M, d = grads.shape
    levels = state.levels
    plan = codec.plan(d)

    # ---- uplink: every worker encodes, as the allreduce's workers do ----
    payloads = sync.encode_workers(grads, codec, levels, plan, u, generator)

    # ---- server: decode and average the M streams in one pass (weighted
    # under a mask) ----
    gathered = WirePayload(torch.stack([p.words for p in payloads]),
                           torch.stack([p.norm_words for p in payloads]))
    transport = (MaskedTransport(active) if active is not None
                 else StackedTransport(M))
    dec = codec.decode_mean(gathered, levels, plan, transport)
    del gathered
    agg = dec.mean                                           # (n,)

    # uplink bytes: measured from the length headers for a
    # variable-volume codec, the plan's otherwise
    if plan.variable:
        up = np.asarray(sync.payload_bits_per_coord(codec, payloads, plan),
                        np.float32) * F32(d / 8.0)
    else:
        up = np.full(M, plan.payload_bytes, np.float32)
    del payloads
    # each worker's own round trip, one stream at a time
    qerr = torch.empty(M, device=grads.device)
    own = (torch.empty((M, d), dtype=torch.float32, device=grads.device)
           if want_own else None)
    for w in range(M):
        row = dec.row(w)[:d]
        qerr[w] = torch.sum((row - grads[w]) ** 2)
        if own is not None:
            own[w] = row
        del row
    del dec

    # ---- downlink: one payload, every worker decodes the same bytes ----
    if server_bits is None:
        down = F32(4.0 * d)                          # raw fp32 broadcast
    else:
        codec2 = requant_codec(codec, server_bits)
        lv2 = uniform_levels(server_bits, device=grads.device)
        plan2 = codec2.plan_buckets(plan.nb)
        pay2 = codec2.encode(agg.view(plan.nb, plan.bucket_size), lv2,
                             plan=plan2, u=u_server, generator=generator)
        agg = codec2.decode(pay2, lv2, plan2)
        down = F32(plan2.payload_bytes)
    recv = np.full(M, down, np.float32)
    server_bytes = up.sum(dtype=np.float32) + F32(M) * down
    return TopologyResult(agg[:d].expand(M, d), up, recv, server_bytes, 2,
                          qerr, own, (up + down) * F32(8.0 / d))


def _topo_ring(grads, scheme, state, active, *, codec, want_own, u_hops,
               generator):
    M, d = grads.shape
    dev = grads.device
    levels = state.levels
    plan = codec.plan(d, shards=M)
    snb, bs = plan.shard_nb, plan.bucket_size
    quantized = scheme.quantized

    # Dropout simplification, as in the reference: a dropped worker's
    # contribution is zeroed and the sum renormalizes over the survivors,
    # but the ring stays closed (its relay traffic is not charged).
    local = grads.new_zeros((M, plan.n))
    local[:, :d] = grads
    if active is not None:
        local.mul_(active.to(dev)[:, None])
    chunks4 = local.view(M, M, snb, bs)      # [worker, chunk]: its buckets
    widx = torch.arange(M, device=dev)

    def draw(h):
        """Hop h's uniforms, all M workers' rows stacked."""
        if u_hops is not None:
            return torch.stack(tuple(u_hops[h])).reshape(M * snb, -1)
        return torch.rand(codec.rounding_shape(M * snb), generator=generator,
                          device=dev)

    def qhop(x, uh, chunk_of_row):
        """One re-quantizing hop: row w of x is worker w's current chunk
        (``chunk_of_row[w]``)."""
        if codec.chunkable:   # one layout: all M workers' rows in one call
            return codec.requantize(x.reshape(M * snb, bs), levels,
                                    plan=plan, u=uh).view(M, snb, bs)
        uw = uh.view(M, snb, -1)
        return torch.stack([codec.requantize(
            x[w], levels, plan=plan, chunk=chunk_of_row[w], u=uw[w])
            for w in range(M)])

    qerr = torch.zeros(M, device=dev)
    u0 = draw(0) if quantized else None
    own = None
    if want_own:
        # Per-hop re-quantization rounds worker w's contribution alone
        # only at hop 0 (chunk w); the compression layer's residual takes
        # the whole first round trip Q(input_w), every chunk on hop 0's
        # uniforms of worker w, so that chunk w matches the wire.
        if not quantized:
            own = grads
        else:
            own = torch.empty_like(grads)
            u0w = u0.view(M, snb, -1)
            for w in range(M):
                own[w] = torch.cat([codec.requantize(
                    chunks4[w, c], levels, plan=plan, chunk=c, u=u0w[w])
                    for c in range(M)]).reshape(-1)[:d]

    # ---- reduce-scatter: M-1 hops of accumulating partial sums ----
    # before hop h, worker w holds its partial of chunk (w - h) mod M
    acc = chunks4[widx, widx]                        # (M, snb, bs)
    for h in range(M - 1):
        if quantized:
            uh = u0 if h == 0 else draw(h)
            q = qhop(acc, uh, [(w - h) % M for w in range(M)])
            del uh
            qerr += torch.sum((q - acc) ** 2, dim=(1, 2))
        else:
            q = acc
        acc = torch.roll(q, 1, 0)                    # from worker w-1
        acc += chunks4[widx, (widx - 1 - h) % M]
        del q
    del u0

    # worker w now holds the full sum of chunk (w + 1) mod M
    if active is None:
        acc.mul_(1.0 / M)                            # sum -> mean
    else:
        acc.mul_(1.0 / torch.clamp(active.to(dev).sum(), min=1.0))

    # ---- all-gather: M-1 hops circulating the finished chunks ----
    # the reduce hops are done with the inputs: their buffer holds the
    # views; every (worker, chunk) entry is written below
    views = chunks4
    views[widx, (widx + 1) % M] = acc
    cur = acc
    for h in range(M - 1):
        if quantized:
            q = qhop(cur, draw(M - 1 + h), [(w + 1 - h) % M for w in range(M)])
            qerr += torch.sum((q - cur) ** 2, dim=(1, 2))
        else:
            q = cur
        cur = torch.roll(q, 1, 0)                    # from worker w-1
        del q
        views[widx, (widx - h) % M] = cur
    out = local[:, :d]

    # ring hops re-encode in value space, so there are no headers to read:
    # a variable-volume codec is billed at capacity
    chunk_bytes = plan.payload_bytes if quantized else 4.0 * plan.shard_n
    vol = np.full(M, 2.0 * (M - 1) * chunk_bytes, np.float32)
    return TopologyResult(out, vol, vol, F32(0.0), 2 * (M - 1), qerr, own,
                          vol * F32(8.0 / d))


def run_topology(
    name: str,
    grads: torch.Tensor,
    scheme: QuantScheme,
    state: SchemeState,
    *,
    active: torch.Tensor | np.ndarray | None = None,
    sync_mode: str = "all_gather",
    server_bits: int | None = sync.TWO_PHASE_BITS,
    codec: GradientCodec | None = None,
    want_own: bool = False,
    fault: FaultModel | None = None,
    fault_step: int = 0,
    u: Uniforms = None,
    u2: Uniforms = None,
    u_server: torch.Tensor | None = None,
    u_hops: Sequence[Uniforms] | None = None,
    generator: torch.Generator | None = None,
) -> TopologyResult:
    """Synchronize (M, d) per-worker gradients over a named topology.

    Args:
      name: 'allreduce' | 'param_server' | 'ring'.
      grads: (M, d) stacked local gradients (M logical workers); read,
        never written.
      scheme / state: quantization method and adaptive state, as in
        ``quantized_allreduce``.
      active: (M,) float weights, 1.0 = the worker's payload arrives (a
        fraction down-weights a stale one); None means a homogeneous
        cluster and keeps the plain ``mean(0)``.  Absent workers leave
        the aggregate, which renormalizes over the rest.
      sync_mode: wire mode of the allreduce topology (an fp32 scheme is
        exact everywhere).
      server_bits: param_server downlink grid; None broadcasts raw fp32.
      codec: wire codec; the scheme's uniform codec by default.
      want_own: also fill ``TopologyResult.own``, each worker's own lossy
        round trip (the ring pays one more requantize pass for it).
      fault / fault_step: wire faults on the allreduce topology, the
        only one that runs the real ``dist.sync`` wire; asking for them
        on another topology raises.
      u, u2, u_server, u_hops, generator: the uniforms of the stochastic
        rounding (see the module docstring), drawn from ``generator``
        where not given.
    """
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.float32)
    if codec is None:
        codec = codec_for_scheme(scheme)
    if (fault is not None and fault.any_wire_faults
            and name != "allreduce"):
        raise ValueError(
            f"wire-fault injection targets the real dist.sync collective "
            f"(topology 'allreduce'); topology {name!r} does not run it")
    if name == "allreduce" or (name == "param_server"
                               and not scheme.quantized):
        return _topo_allreduce(
            grads, scheme, state, active,
            mode=sync_mode if name == "allreduce" else "fp32", codec=codec,
            want_own=want_own, fault=fault, fault_step=fault_step, u=u,
            u2=u2, generator=generator)
    if name == "param_server":
        return _topo_param_server(
            grads, scheme, state, active, server_bits=server_bits,
            codec=codec, want_own=want_own, u=u, u_server=u_server,
            generator=generator)
    if name == "ring":
        return _topo_ring(grads, scheme, state, active, codec=codec,
                          want_own=want_own, u_hops=u_hops,
                          generator=generator)
    raise ValueError(f"unknown topology {name!r}; known: {TOPOLOGIES}")


def run_compressed(
    name: str,
    grads: torch.Tensor,
    scheme: QuantScheme,
    state: SchemeState,
    algorithm,
    comp_state,
    *,
    active: torch.Tensor | np.ndarray | None = None,
    sync_mode: str = "all_gather",
    server_bits: int | None = sync.TWO_PHASE_BITS,
    fault: FaultModel | None = None,
    fault_step: int = 0,
    u: Uniforms = None,
    u2: Uniforms = None,
    u_server: torch.Tensor | None = None,
    u_hops: Sequence[Uniforms] | None = None,
    generator: torch.Generator | None = None,
):
    """``run_topology`` under a ``repro_torch.compress`` algorithm.

    The same prepare -> wire -> feedback hook as ``dist.sync
    .compressed_allreduce``, with per-worker residuals: worker w's
    residual comes from its own round trip only.  ``algorithm.prepare``
    adds the residual to ``grads`` IN PLACE (the rows then hold what is
    encoded).  With the stateless ``plain`` algorithm the aggregate is
    ``run_topology``'s on the same codec, bit for bit.

    Returns ``(TopologyResult, new comp_state)``.
    """
    prep = algorithm.prepare(grads, comp_state)
    res = run_topology(
        name, prep, scheme, state, active=active, sync_mode=sync_mode,
        server_bits=server_bits,
        codec=algorithm.codec if scheme.quantized else None,
        want_own=algorithm.stateful, fault=fault, fault_step=fault_step,
        u=u, u2=u2, u_server=u_server, u_hops=u_hops, generator=generator)
    if algorithm.stateful:
        for w in range(prep.shape[0]):
            algorithm.feedback(comp_state, w, prep[w], res.own[w])
    return res, algorithm.advance(comp_state)
