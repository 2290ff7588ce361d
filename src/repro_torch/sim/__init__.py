"""repro_torch.sim: a cluster simulator for quantized data-parallel
training, the counterpart of the reference package's ``repro.sim``.

Runs M logical workers on one device against pluggable aggregation
topologies (the production allreduce on stacked workers, a QSGD-style
parameter server, a per-hop re-quantizing ring) and heterogeneous cluster
models (bandwidth spread, stragglers, dropout, crash/rejoin), and writes
per-step JSON trajectories of loss, wire bytes, simulated wall-clock and
gradient-statistics drift.

    python -m repro_torch.sim --scenario paper_mlp

runs on the CUDA device (``--device cpu`` on the CPU).
"""
from .cluster import (  # noqa: F401
    ClusterConfig,
    ClusterState,
    init_cluster_state,
    sample_step,
    step_faults,
    step_time_ms,
)
from .scenario import SCENARIOS, Scenario, register, run_scenario  # noqa: F401
from .topology import (  # noqa: F401
    SIM_AXIS,
    TOPOLOGIES,
    TopologyResult,
    run_compressed,
    run_topology,
)
