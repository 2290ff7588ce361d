"""Declarative scenario registry and the simulated training loop.

A scenario is (scheme grid) x (topology grid) x (compression grid) x
(fault grid) x (cluster model) x (model config): each cell trains the
model for ``steps`` simulated steps with M logical workers on one device,
threading the scheme's adaptive state (sufficient statistics merged over
the simulated workers, the paper's Algorithm 1 line 4) through the chosen
aggregation topology, and records a per-step trajectory: loss, wire bytes
by direction, simulated wall-clock from the cluster cost model,
end-to-end aggregate error and gradient-statistics drift.  It is the
counterpart of the reference package's ``repro.sim.scenario``, with the
same registry and the same JSON.

The per-worker protocol is the paper's own evaluation setup (Sec. 5:
"simulate training with M GPUs on a single GPU"), with full topology
semantics: stragglers, dropout, crash/rejoin and per-hop re-quantization
shape what the optimizer sees.

Everything is deterministic in the scenario config on one device: the
weights, the data, the rounding uniforms (a ``torch.Generator`` on the
model's device seeded from ``(seed + 7, step)`` each step) and the
cluster draws (numpy), so a scenario emits the same trajectory on every
run.  PyTorch cannot reproduce the reference's ``jax.random`` weights and
uniforms, so the two packages' trajectories differ in their losses and
errors; the cost model's numbers (bytes, hops, simulated time) and the
cluster's events are the same.

Two fields exist only in the port, for running a full-width model on one
card: ``layers`` cuts the depth (the launcher's ``--layers``) and
``data`` picks the token task (``--data``; the markov task's bigram table
is V x V floats, too large at a vocabulary of 128,256).  Every registered
scenario keeps their defaults.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import configs
from repro_torch.compress import CompressionAlgorithm, make_algorithm
from repro_torch.core.codec import (
    EntropyCodec,
    GradientCodec,
    MixedWidthCodec,
    codec_for_scheme,
    entropy_codec_from_gradient,
    mixed_widths_from_gradient,
    requant_codec,
)
from repro_torch.core.schemes import QuantScheme
from repro_torch.core.stats import expected_variance
from repro_torch.dist import sync
from repro_torch.dist.faults import FaultModel
from repro_torch.models.transformer import Model
from repro_torch.numerics import worker_mean
from repro_torch.timing import NO_CLOCK, StageClock
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.train.optim import OptimConfig, apply_updates, init_opt_state

from .cluster import (
    ClusterConfig,
    init_cluster_state,
    sample_step,
    step_faults,
    step_time_ms,
)
from .topology import TOPOLOGIES, run_compressed


@dataclasses.dataclass(frozen=True)
class Scenario:
    """One named scenario grid (see SCENARIOS for the registry)."""

    name: str
    description: str = ""
    arch: str = "paper-proxy"
    # the port's depth cut (0 = as configured) and token task
    # ('markov' | 'uniform'), for a full-width model on one card
    layers: int = 0
    data: str = "markov"
    # scheme specs: "alq" or "alq:4" (name:bits), the grid's rows
    schemes: tuple = ("alq", "qsgdinf")
    topologies: tuple = TOPOLOGIES
    bits: int = 3
    bucket_size: int = 512
    steps: int = 10
    batch_per_worker: int = 2
    seq_len: int = 32
    lr: float = 1e-3
    optimizer: str = "adamw"
    update_milestones: tuple = (2, 6)   # level-adaptation steps
    sync_mode: str = "all_gather"       # allreduce topology wire mode
    server_bits: int | None = 8         # param_server downlink grid
    norm_dtype: str = "float32"
    # 'uniform' | 'mixed_width' | 'entropy' (the entropy-coded wire, its
    # canonical-Huffman table fit from a probe-step gradient and re-fit at
    # every level-update milestone, so that the measured bits/coord track
    # the metered entropy_bits_per_coord as the grid adapts)
    codec: str = "uniform"
    # static per-bucket scheme-bits pattern of the mixed-width codec;
    # empty = a probe-step bit assignment (budget = the scheme's bits),
    # re-derived at every level-update milestone
    mixed_width_pattern: tuple = ()
    # compression-algorithm specs (repro_torch.compress), the grid's third
    # axis: 'plain' | 'ef[:warmup]' | 'topk[:k]'
    compress: tuple = ("plain",)
    cluster: ClusterConfig = ClusterConfig()
    # per-bucket checksum words on every cell's wire; corrupt buckets are
    # excluded (needs a uniform or entropy codec)
    integrity: bool = False
    # fault-model grid axis: a ``dist.faults.FaultModel`` or None
    # (fault-free).  Wire faults (flips/drops/delays) hit the allreduce
    # collective through a FaultyTransport; crash/rejoin steps the
    # host-side Markov chain (``cluster.step_faults``), whose staleness
    # weights feed the MaskedTransport renormalization.
    fault_grid: tuple = (None,)
    seed: int = 0

    def make_scheme(self, spec: str) -> QuantScheme:
        name, _, b = spec.partition(":")
        return QuantScheme(
            name=name, bits=int(b) if b else self.bits,
            bucket_size=self.bucket_size, norm_dtype=self.norm_dtype)


SCENARIOS: dict[str, Scenario] = {}


def register(s: Scenario) -> Scenario:
    if s.name in SCENARIOS:
        raise ValueError(f"duplicate scenario {s.name!r}")
    SCENARIOS[s.name] = s
    return s


register(Scenario(
    name="paper_mlp",
    description="ALQ vs QSGDinf on the paper-scale proxy across all three "
                "topologies, homogeneous 4-worker cluster (the acceptance "
                "grid; also the CI smoke scenario).",
))
register(Scenario(
    name="stragglers",
    description="One-in-four steps a worker computes 4x slower: adaptive "
                "schemes keep their accuracy edge while every topology's "
                "simulated throughput degrades.",
    schemes=("alq", "qsgdinf"),
    cluster=ClusterConfig(straggler_prob=0.25, straggler_scale=4.0),
))
register(Scenario(
    name="hetero_bandwidth",
    description="Per-worker link speeds spanning 8x (2.5..20 Gb/s): "
                "param_server funnels through the server link while "
                "ring is gated by the slowest hop.",
    cluster=ClusterConfig(bandwidth_gbps=(2.5, 5.0, 10.0, 20.0)),
))
register(Scenario(
    name="dropout",
    description="Workers vanish for a step with p=0.2; aggregates "
                "renormalize over survivors (worker 0 never drops).",
    schemes=("alq",),
    cluster=ClusterConfig(dropout_prob=0.2),
))
register(Scenario(
    name="mixed_bits",
    description="Width sweep on the allreduce topology: the scheme grid "
                "crosses ALQ/QSGDinf with 2- and 4-bit grids.",
    schemes=("alq:2", "alq:4", "qsgdinf:2", "qsgdinf:4"),
    topologies=("allreduce",),
))
register(Scenario(
    name="ring_compounding",
    description="8-worker ring vs flat allreduce: per-hop re-quantization "
                "compounds error with ring distance; fp32 is the exact "
                "baseline.",
    schemes=("alq", "qsgdinf", "fp32"),
    topologies=("ring", "allreduce"),
    cluster=ClusterConfig(num_workers=8),
    steps=8,
))
register(Scenario(
    name="fp16_norms",
    description="The fp16 bucket-norm wire option end to end: identical "
                "grid to paper_mlp but with half-width norm side-channel.",
    norm_dtype="float16",
))
register(Scenario(
    name="mixed_width",
    description="MixedWidthCodec end to end: per-bucket wire widths from "
                "a probe-step bit assignment (high-norm/high-variance "
                "buckets get more levels at the scheme's mean-bits "
                "budget), threaded through allreduce and param_server.",
    schemes=("alq", "qsgdinf"),
    topologies=("allreduce", "param_server"),
    codec="mixed_width",
))
register(Scenario(
    name="entropy_coded",
    description="EntropyCodec end to end: the metered entropy cost "
                "realized as actual coded bytes.  The canonical-Huffman "
                "table is fit from a probe-step gradient and re-fit at "
                "every level-update milestone; the cost model bills "
                "makespan by the MEASURED per-bucket coded lengths, so "
                "measured bits/coord drop below the fixed-width plan "
                "and track entropy_bits_per_coord as the grid adapts.  "
                "Error feedback stacks on top unchanged (the ef cells "
                "are bit-exact with ef over the uniform codec).",
    schemes=("alq",),
    topologies=("allreduce", "param_server"),
    compress=("plain", "ef"),
    codec="entropy",
))
register(Scenario(
    name="ef_vs_plain",
    description="Error feedback at a 2-bit uniform grid: the residual "
                "memory re-injects each step's quantization error, so "
                "the CUMULATIVE aggregate error (cum_agg_err) stays "
                "bounded while the stateless 2-bit wire random-walks — "
                "EF's end-of-run cum_agg_err is strictly lower.",
    schemes=("qsgdinf:2",),
    topologies=("allreduce",),
    compress=("plain", "ef"),
    steps=10,
))
register(Scenario(
    name="fault_tolerance",
    description="The production allreduce under injected wire faults "
                "with integrity words on: per-word bit flips (~5% of "
                "buckets hit), whole-payload drops/delays, and a "
                "crash/rejoin Markov chain whose rejoining workers "
                "contribute staleness-weighted payloads.  Detected-"
                "corrupt buckets are excluded and renormalized, so the "
                "faulty cell's end-of-run loss stays within a few "
                "percent of the fault-free cell (acceptance: <= 10%).",
    schemes=("alq",),
    topologies=("allreduce",),
    integrity=True,
    # per-WORD flip probability: a 512-coordinate 3-bit bucket spans 65
    # wire words, so ~5% of buckets catch at least one flipped bit
    fault_grid=(None,
                FaultModel(flip_prob=0.0008, drop_prob=0.01,
                           delay_prob=0.01, crash_prob=0.08,
                           rejoin_prob=0.5, seed=13)),
    steps=10,
))
register(Scenario(
    name="topk_sweep",
    description="Top-k sparsification at the equal-wire-budget default "
                "k (index+value payloads cost what the dense symbols "
                "would): per-step error pays for the dropped support, "
                "but the EF memory keeps the cumulative aggregate error "
                "bounded where the dense stateless wire drifts.",
    schemes=("qsgdinf:2",),
    topologies=("allreduce", "param_server"),
    compress=("plain", "topk"),
    steps=10,
))



# ---------------------------------------------------------------------------
# one grid cell = (scheme, topology, compress, fault) for `steps` steps
# ---------------------------------------------------------------------------

def exact_mean(flats: torch.Tensor, active=None) -> torch.Tensor:
    """The exact fp32 mean of the (M, d) gradient rows, against which the
    aggregate's end-to-end error is measured: the reference's
    ``flats.mean(0)`` (``numerics.worker_mean``), or with the (M,) float32
    ``active`` weights of a masked cell their renormalized combination."""
    if active is None:
        return worker_mean(flats)
    wmask = (active / torch.clamp(active.sum(), min=1.0)).to(flats.device)
    return torch.tensordot(wmask, flats, dims=([0], [0]))


def step_seed(seed: int, step: int) -> int:
    """The seed of step ``step``'s rounding generator: (seed + 7, step)
    -> a 63-bit int, the counterpart of the reference's
    ``fold_in(PRNGKey(seed + 7), step)``."""
    ss = np.random.SeedSequence([seed + 7, int(step)])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


class Cell:
    """The training state of one cell on the model's device: flat
    parameters (the model's), optimizer moments, the scheme state, the
    compression state, the (M, d) gradient rows and the (d,) cumulative
    aggregate-error vector.  ``step`` is the counterpart of the
    reference's jitted cell step."""

    def __init__(self, scn: Scenario, scheme: QuantScheme, topo: str,
                 algo: CompressionAlgorithm, model: Model,
                 fault: FaultModel | None = None):
        M = scn.cluster.num_workers
        dev = model.flat.device
        self.scn, self.scheme, self.topo = scn, scheme, topo
        self.algo, self.model, self.fault = algo, model, fault
        self.ocfg = OptimConfig(name=scn.optimizer, lr=scn.lr,
                                weight_decay=0.0)
        self.opt = init_opt_state(self.ocfg, model.flat)
        self.scheme_state = scheme.init_state(dev)
        self.comp_state = algo.init_state(M, model.d, dev)
        self.grads = torch.zeros((M, model.d), device=dev)
        self.cum_err = torch.zeros(model.d, device=dev)
        # no dropout and no crash/rejoin: every weight is 1, and the
        # topologies keep the plain mean; staleness weights are
        # fractional, so they too need the masked path
        self.masked = (scn.cluster.dropout_prob > 0
                       or (fault is not None and fault.crash_prob > 0))

    def step(self, batch: dict[str, torch.Tensor], *, active, do_update: bool,
             fault_step: int, generator: torch.Generator | None = None,
             clock=NO_CLOCK, **uniforms) -> dict[str, Any]:
        """One simulated step on a global batch; ``active`` (M,) are the
        workers' weights this step; ``uniforms`` (``u``, ``u2``,
        ``u_server``, ``u_hops``) go to the topology, which draws what is
        not given from ``generator``.  Returns the step's metrics."""
        scheme, model = self.scheme, self.model
        M = self.grads.shape[0]
        per = batch["ids"].shape[0] // M
        losses = []
        for w in range(M):
            g = self.grads[w]
            g.zero_()
            model.attach_grads(g)
            rows = slice(w * per, (w + 1) * per)
            loss = model.loss(batch["ids"][rows], batch["labels"][rows])
            loss.backward()            # accumulates into the worker's row
            losses.append(loss.detach())
        flats = self.grads
        clock.mark("grad")

        # taken before the compression hook forms its input in the rows
        act = torch.as_tensor(np.asarray(active), dtype=torch.float32)
        exact = exact_mean(flats, act if self.masked else None)

        # Algorithm 1 line 4 on the simulated cluster: statistics merged
        # over the M logical workers; the new levels apply from the next
        # step (the topology below runs on the current ones)
        state = self.scheme_state
        new_state = state
        if scheme.adaptive and do_update:
            new_state = scheme.update_state(state,
                                            sync.gather_stats(flats, scheme))
            clock.mark("stats")
        # drift: the pooled truncated-normal fit of worker 0's normalized
        # magnitudes and the paper's Psi at the (updated) levels
        now = sync.gather_stats(flats[:1], scheme)
        drift_mu = torch.sum(now.gamma * now.mu)
        drift_sigma = torch.sum(now.gamma * now.sigma)
        psi = expected_variance(now, new_state.levels)
        clock.mark("drift")

        res, self.comp_state = run_compressed(
            self.topo, flats, scheme, state, self.algo, self.comp_state,
            active=act if self.masked else None,
            sync_mode=self.scn.sync_mode, server_bits=self.scn.server_bits,
            fault=self.fault, fault_step=fault_step, generator=generator,
            **uniforms)
        clock.mark("topology")
        agg = res.aggregate[0]
        diff = agg - exact
        agg_err = torch.sum(diff * diff)
        # the cumulative aggregate-error vector: what error feedback
        # bounds (a stateless wire's sum of errors random-walks)
        self.cum_err += diff
        del diff
        cum_agg_err = torch.sum(self.cum_err * self.cum_err)
        grad_norm = torch.sqrt(torch.sum(exact * exact))
        del exact
        self.opt = apply_updates(self.ocfg, model.flat, agg, self.opt)
        del agg
        self.scheme_state = new_state
        clock.mark("optimizer")
        return {
            "loss": worker_mean(torch.stack(losses)).item(),
            "agg_err": agg_err.item(),
            "cum_agg_err": cum_agg_err.item(),
            "quant_error": worker_mean(res.quant_error).item(),
            "residual_norm": worker_mean(
                self.comp_state.residual_norm).item(),
            "kept_fraction": float(np.float32(self.algo.kept_fraction)),
            "grad_norm": grad_norm.item(),
            "sent_bytes": res.sent_bytes,
            "recv_bytes": res.recv_bytes,
            "server_bytes": res.server_bytes,
            "hops": res.hops,
            "drift_mu": drift_mu.item(),
            "drift_sigma": drift_sigma.item(),
            "psi": psi.item(),
            "levels": new_state.levels,
            "entropy_bits_per_coord": float(new_state.entropy_bits),
            # worker 0's shipped wire bits/coord (both directions),
            # measured for the entropy wire, the plan's otherwise
            "measured_bits_per_coord": float(res.wire_bits_per_coord[0]),
            "corrupt_fraction": res.corrupt_fraction,
            "excluded_workers": res.excluded_workers,
        }


def _probe_gradient(model: Model, batch, per_worker: int) -> torch.Tensor:
    """Worker 0's probe-step gradient: one backward on the first batch
    shard, the raw material of every host-level codec fit (the
    mixed-width bit assignment and the entropy-table refit)."""
    g = torch.zeros(model.d, device=model.flat.device)
    model.attach_grads(g)
    model.loss(batch["ids"][:per_worker],
               batch["labels"][:per_worker]).backward()
    return g


def _probe_mixed_widths(model: Model, scheme: QuantScheme, batch,
                        per_worker: int) -> tuple:
    """Per-bucket bit assignment from the probe gradient: the static
    width pattern the cell runs on."""
    return mixed_widths_from_gradient(
        _probe_gradient(model, batch, per_worker), scheme)


def _probe_entropy_codec(model: Model, scheme: QuantScheme, batch,
                         per_worker: int, levels) -> EntropyCodec:
    """Canonical-Huffman table from the probe gradient's level
    occupancies at the CURRENT grid."""
    return entropy_codec_from_gradient(
        _probe_gradient(model, batch, per_worker), scheme, levels)


def _make_cell_codec(scn: Scenario, scheme: QuantScheme, model: Model,
                     batch) -> GradientCodec | None:
    if not scheme.quantized:
        return None
    if scn.codec == "uniform":
        if not scn.integrity:
            return None          # the scheme's codec: the production path
        return dataclasses.replace(codec_for_scheme(scheme), integrity=True)
    if scn.codec == "entropy":
        codec = _probe_entropy_codec(model, scheme, batch,
                                     scn.batch_per_worker,
                                     scheme.init_levels(model.flat.device))
        if scn.integrity:
            codec = dataclasses.replace(codec, integrity=True)
        return codec
    if scn.codec != "mixed_width":
        raise ValueError(f"unknown scenario codec {scn.codec!r}")
    if scn.integrity:
        raise ValueError(
            "integrity=True needs a per-bucket checksum slot; the "
            "mixed-width payload family has none (use 'uniform' or "
            "'entropy')")
    widths = scn.mixed_width_pattern or _probe_mixed_widths(
        model, scheme, batch, scn.batch_per_worker)
    return MixedWidthCodec(bucket_size=scheme.bucket_size,
                           norm_type=scheme.norm_type,
                           norm_dtype=scheme.norm_dtype,
                           widths=tuple(int(b) for b in widths))


def _fixed_bits_per_coord(scn: Scenario, scheme: QuantScheme, topo: str,
                          d: int) -> float:
    """The fixed-width (uniform-codec) counterpart of the trajectory's
    per-worker ``measured_bits_per_coord`` for this topology: the plan an
    entropy-coded cell must beat.  The gather hop for allreduce, uplink +
    downlink for param_server."""
    if not scheme.quantized:
        return 32.0
    uc = codec_for_scheme(scheme)
    plan = uc.plan(d)
    if topo == "param_server":
        if scn.server_bits is None:
            down = 32.0
        else:
            c2 = requant_codec(uc, scn.server_bits)
            down = 8.0 * c2.plan_buckets(plan.nb).payload_bytes / d
        return float(plan.bits_per_coord + down)
    if topo == "ring":
        M = scn.cluster.num_workers
        splan = uc.plan(d, shards=M)
        return float(2.0 * (M - 1) * splan.payload_bytes * 8.0 / d)
    if scn.sync_mode == "two_phase":
        # reduce hop (the scheme's grid, sharded) + 8-bit broadcast hop
        M = scn.cluster.num_workers
        splan = uc.plan(d, shards=M)
        p2 = requant_codec(uc, sync.TWO_PHASE_BITS).plan_buckets(
            splan.shard_nb)
        return float(splan.bits_per_coord
                     + 32.0 * (p2.code_words + p2.norm_words) / d)
    return float(plan.bits_per_coord)


def _run_cell(scn: Scenario, spec: str, topo: str, comp_spec: str,
              steps: int, device, fault: FaultModel | None = None,
              time_stages: bool = False) -> dict[str, Any]:
    scheme = scn.make_scheme(spec)
    cfg = configs.get_config(scn.arch)
    if scn.layers:
        cfg = dataclasses.replace(cfg, num_layers=scn.layers)
    M = scn.cluster.num_workers
    device = torch.device(device)
    model = Model(cfg, device=device, seed=scn.seed)
    pipe = Pipeline(DataConfig(
        kind=scn.data, vocab_size=cfg.vocab_size, seq_len=scn.seq_len,
        global_batch=scn.batch_per_worker * M, seed=scn.seed))

    codec = _make_cell_codec(scn, scheme, model, pipe.batch(0, device))
    cell = Cell(scn, scheme, topo, make_algorithm(comp_spec, scheme,
                                                  codec=codec),
                model, fault)

    # widths and entropy tables are static layout, so tracking drifting
    # bucket statistics happens here: on every level-update milestone the
    # probe re-runs on the current parameters' gradient and the cell goes
    # on with the fresh codec
    reassign = (scn.codec == "mixed_width" and scheme.quantized
                and not scn.mixed_width_pattern)
    refit_table = scn.codec == "entropy" and scheme.quantized
    width_reassignments: list[dict[str, Any]] = []
    table_refits: list[dict[str, Any]] = []

    traj = []
    sim_time = 0.0
    wire_total = 0.0
    fault_events: list[dict[str, Any]] = []
    cstate = (init_cluster_state(M)
              if fault is not None and fault.crash_prob > 0 else None)
    for t in range(steps):
        batch = pipe.batch(t, device)
        compute_ms, active = sample_step(scn.cluster, t)
        if cstate is not None:
            # crash/rejoin Markov chain: crashed workers weigh 0, rejoining
            # ones the staleness weight 1/(1+k), through the MaskedTransport
            cstate, fweight, events = step_faults(fault, cstate, t)
            active = active * fweight
            fault_events.extend(events)
        gen = torch.Generator(device=device).manual_seed(
            step_seed(scn.seed, t))
        clock = StageClock(device) if time_stages else NO_CLOCK
        t_step = time.perf_counter()
        m = cell.step(batch, active=active,
                      do_update=t in scn.update_milestones, fault_step=t,
                      generator=gen, clock=clock)
        step_ms = (time.perf_counter() - t_step) * 1e3
        levels = m["levels"]
        if reassign and t in scn.update_milestones:
            new_widths = _probe_mixed_widths(model, scheme, batch,
                                             scn.batch_per_worker)
            changed = tuple(new_widths) != tuple(codec.widths)
            width_reassignments.append({
                "step": t,
                "changed": changed,
                "mean_width": float(np.mean(new_widths)),
                "widths": [int(b) for b in new_widths],
            })
            if changed:
                codec = dataclasses.replace(
                    codec, widths=tuple(int(b) for b in new_widths))
                cell.algo = make_algorithm(comp_spec, scheme, codec=codec)
        if refit_table and t in scn.update_milestones:
            # the levels just adapted: re-fit the table to the NEW grid's
            # occupancies on a fresh probe gradient
            new_codec = _probe_entropy_codec(model, scheme, batch,
                                             scn.batch_per_worker, levels)
            changed = (new_codec.huff_lengths != codec.huff_lengths
                       or new_codec.huff_codes != codec.huff_codes)
            table_refits.append({
                "step": t,
                "changed": changed,
                "max_code_bits": max(new_codec.huff_lengths),
                "code_lengths": [int(n) for n in new_codec.huff_lengths],
            })
            if changed:
                codec = new_codec
                cell.algo = make_algorithm(comp_spec, scheme, codec=codec)
        sent = np.asarray(m["sent_bytes"], np.float64)
        recv = np.asarray(m["recv_bytes"], np.float64)
        server = float(m["server_bytes"])
        hops = int(m["hops"])
        dt = step_time_ms(scn.cluster, compute_ms, active, sent, recv,
                          server, hops)
        if fault is not None and fault.delay_prob > 0:
            # a delayed payload stalls the aggregation window: bill
            # delay_ms once if any surviving worker's payload is late
            delayed = fault.delayed_workers(t, M, device).cpu().numpy()
            if bool(delayed[np.asarray(active) > 0].any()):
                dt += fault.delay_ms
        sim_time += dt
        # total bytes crossing worker NICs (the server's own link shows up
        # in recv, not double-counted)
        step_wire = float(((sent + recv) * (active > 0)).sum())
        wire_total += step_wire
        entry = {
            "step": t,
            "loss": m["loss"],
            "sim_time_ms": dt,
            "cum_sim_time_ms": sim_time,
            "wire_sent_bytes": sent.tolist(),
            "wire_recv_bytes": recv.tolist(),
            "server_bytes": server,
            "hops": hops,
            "agg_err": m["agg_err"],
            "cum_agg_err": m["cum_agg_err"],
            "quant_error": m["quant_error"],
            "residual_norm": m["residual_norm"],
            "kept_fraction": m["kept_fraction"],
            "grad_norm": m["grad_norm"],
            "drift_mu": m["drift_mu"],
            "drift_sigma": m["drift_sigma"],
            "psi": m["psi"],
            "entropy_bits_per_coord": m["entropy_bits_per_coord"],
            "measured_bits_per_coord": m["measured_bits_per_coord"],
            "levels": levels.tolist(),
            "compute_ms": np.asarray(compute_ms).tolist(),
            "active": [bool(a > 0) for a in active],
            "active_weight": [float(a) for a in np.asarray(active)],
            "corrupt_fraction": m["corrupt_fraction"],
            "excluded_workers": m["excluded_workers"],
        }
        if time_stages:
            entry["step_ms"] = step_ms
            entry["stage_ms"] = clock.stage_ms()
        traj.append(entry)
    return {
        "scheme": spec,
        "topology": topo,
        "compress": comp_spec,
        "bits": scheme.bits,
        "norm_dtype": scheme.norm_dtype,
        "codec": scn.codec if scheme.quantized else "uniform",
        "kept_fraction": float(cell.algo.kept_fraction),
        "mean_width": (codec.mean_scheme_bits
                       if isinstance(codec, MixedWidthCodec)
                       else float(scheme.bits)),
        "width_reassignments": width_reassignments,
        "table_refits": table_refits,
        "integrity": bool(scn.integrity and scheme.quantized),
        "fault": dataclasses.asdict(fault) if fault is not None else None,
        "fault_events": fault_events,
        "fixed_bits_per_coord": _fixed_bits_per_coord(scn, scheme, topo,
                                                      model.d),
        "steps": traj,
        "totals": {
            "sim_time_ms": sim_time,
            "wire_bytes": wire_total,
            "final_loss": traj[-1]["loss"] if traj else None,
            "mean_agg_err": (float(np.mean([s["agg_err"] for s in traj]))
                             if traj else None),
            "final_cum_agg_err": (traj[-1]["cum_agg_err"] if traj
                                  else None),
            "mean_corrupt_fraction": (
                float(np.mean([s["corrupt_fraction"] for s in traj]))
                if traj else None),
        },
    }


def run_scenario(scn: Scenario, *, steps: int | None = None,
                 workers: int | None = None, device="cuda",
                 time_stages: bool = False) -> dict[str, Any]:
    """Run every (scheme, topology, compress, fault) cell of a scenario
    on ``device``; a JSON-ready dict.  ``time_stages`` adds each step's
    host-clock ``step_ms`` and its ``stage_ms`` (grad, stats, drift,
    topology, optimizer) to the trajectory."""
    if workers is not None:
        scn = dataclasses.replace(
            scn, cluster=dataclasses.replace(scn.cluster,
                                             num_workers=workers))
    n_steps = steps if steps is not None else scn.steps
    cells = []
    for spec in scn.schemes:
        for topo in scn.topologies:
            for comp in scn.compress:
                for fault in (scn.fault_grid or (None,)):
                    cells.append(_run_cell(scn, spec, topo, comp, n_steps,
                                           device, fault=fault,
                                           time_stages=time_stages))
    return {
        "scenario": scn.name,
        "description": scn.description,
        "config": dataclasses.asdict(scn),
        "num_steps": n_steps,
        "cells": cells,
    }
