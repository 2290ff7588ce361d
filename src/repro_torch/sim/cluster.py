"""Worker heterogeneity models and the simulated wall-clock cost model.

A copy of the reference package's ``repro.sim.cluster``: pure numpy,
seeded by ``SeedSequence``, so both packages draw the same clusters bit
for bit.

The simulator is bulk-synchronous: a step's simulated time is the
makespan of its slowest surviving worker plus whatever the aggregation
point serializes.  All randomness (straggler draws, dropout draws,
compute jitter) is host-side numpy, seeded from ``(seed, step)`` with a
``SeedSequence`` — the same scenario config always produces the same
trajectory, bit for bit.

Cost model (formulas also in docs/simulator.md):

    compute_w = compute_ms * jitter_w * (straggler_scale if straggling)
    comm_w    = sent_bytes_w / bw_w + recv_bytes_w / bw_w
    t_step    = max over ACTIVE workers (compute_w + comm_w)
                + server_bytes / server_bw          (param_server only)
                + hops * latency_ms

with per-worker full-duplex link bandwidth ``bw_w`` (heterogeneous when
``bandwidth_gbps`` is a tuple) and one shared server link.  Dropped
workers spend no time (they are absent for the step) and their payloads
are excluded from the aggregate by the topology layer.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    """One logical cluster: link speeds, stragglers, dropout."""

    num_workers: int = 4
    # per-worker link bandwidth; scalar = homogeneous, tuple = one entry
    # per worker (cycled if shorter than num_workers)
    bandwidth_gbps: float | tuple = 10.0
    server_bandwidth_gbps: float = 40.0   # param-server ingress+egress link
    compute_ms: float = 10.0              # base per-step gradient compute
    compute_jitter: float = 0.0           # lognormal sigma on compute time
    straggler_prob: float = 0.0           # P[worker straggles this step]
    straggler_scale: float = 1.0          # compute multiplier when straggling
    dropout_prob: float = 0.0             # P[worker absent this step]
    latency_ms: float = 0.05              # per serialized hop
    seed: int = 0

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if self.straggler_scale < 1.0:
            raise ValueError("straggler_scale must be >= 1 (it multiplies "
                             "compute time)")
        for f in ("straggler_prob", "dropout_prob"):
            p = getattr(self, f)
            if not 0.0 <= float(p) <= 1.0:
                raise ValueError(f"{f} must be in [0, 1], got {p}")
        if not np.isscalar(self.bandwidth_gbps):
            if len(self.bandwidth_gbps) == 0:
                raise ValueError(
                    "bandwidth_gbps tuple must be non-empty (it is "
                    "cycled over workers)")
            bad = [b for b in self.bandwidth_gbps if float(b) <= 0]
            if bad:
                raise ValueError(f"bandwidth_gbps must be > 0, got {bad}")
        elif float(self.bandwidth_gbps) <= 0:
            raise ValueError("bandwidth_gbps must be > 0, got "
                             f"{self.bandwidth_gbps}")


def worker_bandwidths(cfg: ClusterConfig) -> np.ndarray:
    """(M,) per-worker link bandwidth in bytes/ms."""
    bw = cfg.bandwidth_gbps
    if np.isscalar(bw):
        per = np.full(cfg.num_workers, float(bw))
    else:
        per = np.array([float(bw[i % len(bw)])
                        for i in range(cfg.num_workers)])
    # 1 Gb/s = 1e9 bits/s = 1.25e5 bytes/ms
    return per * 1.25e5


def _rng(cfg: ClusterConfig, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, 0xC1A5]))


def sample_step(cfg: ClusterConfig, step: int):
    """Deterministic per-step draw -> (compute_ms (M,), active (M,) f32).

    Uses one uniform per worker per effect so the draws are COUPLED
    across config changes: raising ``straggler_prob`` or
    ``straggler_scale`` at a fixed seed can only slow workers down,
    which is what makes the monotonicity property testable.

    Worker 0 never drops: the cluster always has at least one survivor.
    """
    M = cfg.num_workers
    rng = _rng(cfg, step)
    u_straggle = rng.random(M)
    u_drop = rng.random(M)
    jitter = (np.exp(cfg.compute_jitter * rng.standard_normal(M))
              if cfg.compute_jitter > 0 else np.ones(M))

    straggling = u_straggle < cfg.straggler_prob
    factor = np.where(straggling, cfg.straggler_scale, 1.0)
    compute = cfg.compute_ms * jitter * factor

    active = (u_drop >= cfg.dropout_prob).astype(np.float32)
    active[0] = 1.0
    return compute, active


# ---------------------------------------------------------------------------
# crash / rejoin: the per-worker up/down Markov chain
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class ClusterState:
    """Mutable cross-step cluster state: which workers are up, and for
    how many consecutive steps the down ones have been down (the
    staleness of the payload they will rejoin with)."""

    up: np.ndarray           # (M,) bool
    down_steps: np.ndarray   # (M,) int


def init_cluster_state(num_workers: int) -> ClusterState:
    return ClusterState(up=np.ones(num_workers, bool),
                        down_steps=np.zeros(num_workers, np.int64))


def step_faults(faults, state: ClusterState, step: int):
    """Advance the crash/rejoin Markov chain one step.

    ``faults`` is a ``repro_torch.dist.faults.FaultModel`` (``crash_prob`` /
    ``rejoin_prob`` / ``seed``); draws are host-side numpy seeded from
    ``(faults.seed, step)`` — deterministic, same discipline as
    ``sample_step``.  Worker 0 never crashes (the cluster always has a
    survivor, matching the dropout model).

    Returns ``(new_state, weight, events)``:

    * ``weight`` is the (M,) float contribution weight for THIS step:
      1.0 for a healthy worker, 0.0 while down, and the staleness
      weight ``1 / (1 + k)`` on the step a worker rejoins after ``k``
      steps down — its payload is a stale gradient, down-weighted in
      the ``MaskedTransport`` renormalization (the first slice of the
      async/decentralized aggregation story).
    * ``events`` is a JSON-ready list of this step's transitions.
    """
    M = state.up.shape[0]
    rng = np.random.default_rng(
        np.random.SeedSequence([faults.seed, step, 0xFA17]))
    u_crash = rng.random(M)
    u_rejoin = rng.random(M)

    up = state.up.copy()
    down = state.down_steps.copy()
    weight = np.ones(M, np.float32)
    events = []
    for w in range(M):
        if up[w]:
            if w != 0 and u_crash[w] < faults.crash_prob:
                up[w] = False
                down[w] = 1
                weight[w] = 0.0
                events.append({"step": step, "worker": w,
                               "event": "crash"})
        else:
            if u_rejoin[w] < faults.rejoin_prob:
                k = int(down[w])
                up[w] = True
                down[w] = 0
                weight[w] = np.float32(1.0 / (1.0 + k))
                events.append({"step": step, "worker": w,
                               "event": "rejoin", "staleness": k,
                               "weight": float(weight[w])})
            else:
                down[w] += 1
                weight[w] = 0.0
    return ClusterState(up=up, down_steps=down), weight, events


def step_time_ms(
    cfg: ClusterConfig,
    compute_ms: np.ndarray,
    active: np.ndarray,
    sent_bytes: np.ndarray,
    recv_bytes: np.ndarray,
    server_bytes: float,
    hops: int,
) -> float:
    """Simulated wall-clock of one bulk-synchronous step (formula above)."""
    bw = worker_bandwidths(cfg)
    comm = (np.asarray(sent_bytes) + np.asarray(recv_bytes)) / bw
    per_worker = np.asarray(compute_ms) + comm
    mask = np.asarray(active) > 0
    makespan = float(per_worker[mask].max()) if mask.any() else 0.0
    server = float(server_bytes) / (cfg.server_bandwidth_gbps * 1.25e5)
    return makespan + server + float(hops) * cfg.latency_ms
