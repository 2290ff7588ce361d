"""The port's cluster model (``repro_torch.sim.cluster``) against the
reference's, bit for bit: both are numpy seeded by ``SeedSequence``, so
every draw, weight, event and simulated time must be equal over a grid of
configurations and steps.  And ``FaultModel``'s simulator fields: their
defaults and checks as the reference's, and ``delayed_workers`` drawing
exactly the delays ``FaultyTransport`` drops on the wire.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.dist.faults import FaultModel as JFaultModel
from repro.sim import cluster as jcluster
from repro_torch.dist.faults import FaultModel, FaultyTransport, faulty
from repro_torch.dist.transport import StackedTransport
from repro_torch.sim import cluster

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

CONFIGS = [
    dict(),
    dict(num_workers=8, compute_jitter=0.3, straggler_prob=0.25,
         straggler_scale=4.0, seed=3),
    dict(num_workers=3, bandwidth_gbps=(2.5, 5.0), dropout_prob=0.2,
         latency_ms=0.2, seed=11),
    dict(num_workers=5, bandwidth_gbps=(2.5, 5.0, 10.0, 20.0, 1.0),
         server_bandwidth_gbps=10.0, compute_ms=3.0, dropout_prob=0.5),
]


def _pair(kw):
    return jcluster.ClusterConfig(**kw), cluster.ClusterConfig(**kw)


@pytest.mark.parametrize("kw", CONFIGS)
def test_draws_bandwidths_and_step_times_are_bit_exact(kw):
    jcfg, cfg = _pair(kw)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    np.testing.assert_array_equal(cluster.worker_bandwidths(cfg),
                                  jcluster.worker_bandwidths(jcfg))
    M = cfg.num_workers
    rng = np.random.default_rng(0)
    for step in range(12):
        c1, a1 = cluster.sample_step(cfg, step)
        c0, a0 = jcluster.sample_step(jcfg, step)
        np.testing.assert_array_equal(c1, c0)
        np.testing.assert_array_equal(a1, a0)
        assert a1.dtype == a0.dtype
        sent = rng.random(M) * 1e6
        recv = rng.random(M) * 1e6
        for server, hops in ((0.0, 1), (3e6, 2), (0.0, 2 * (M - 1))):
            assert (cluster.step_time_ms(cfg, c1, a1, sent, recv, server,
                                         hops)
                    == jcluster.step_time_ms(jcfg, c0, a0, sent, recv,
                                             server, hops))


@pytest.mark.parametrize("crash,rejoin,seed", [(0.08, 0.5, 13), (0.5, 0.2, 1),
                                               (0.3, 1.0, 7)])
def test_crash_rejoin_chain_is_bit_exact(crash, rejoin, seed):
    jfm = JFaultModel(crash_prob=crash, rejoin_prob=rejoin, seed=seed)
    fm = FaultModel(crash_prob=crash, rejoin_prob=rejoin, seed=seed)
    M = 6
    js, s = jcluster.init_cluster_state(M), cluster.init_cluster_state(M)
    seen = set()
    for step in range(30):
        js, jw, jev = jcluster.step_faults(jfm, js, step)
        s, w, ev = cluster.step_faults(fm, s, step)
        np.testing.assert_array_equal(w, jw)
        assert w.dtype == jw.dtype
        np.testing.assert_array_equal(s.up, js.up)
        np.testing.assert_array_equal(s.down_steps, js.down_steps)
        assert ev == jev
        seen.update(e["event"] for e in ev)
        assert s.up[0]          # worker 0 never crashes
    assert seen == {"crash", "rejoin"}


@pytest.mark.parametrize("kw,match", [
    (dict(num_workers=0), "num_workers"),
    (dict(straggler_scale=0.5), "straggler_scale"),
    (dict(dropout_prob=1.5), "dropout_prob"),
    (dict(straggler_prob=-0.1), "straggler_prob"),
    (dict(bandwidth_gbps=()), "non-empty"),
    (dict(bandwidth_gbps=(1.0, 0.0)), "bandwidth_gbps"),
    (dict(bandwidth_gbps=-1.0), "bandwidth_gbps"),
])
def test_cluster_config_checks_as_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        jcluster.ClusterConfig(**kw)
    with pytest.raises(ValueError, match=match):
        cluster.ClusterConfig(**kw)


def test_fault_model_fields_and_defaults_match_reference():
    assert ([f.name for f in dataclasses.fields(FaultModel)]
            == [f.name for f in dataclasses.fields(JFaultModel)])
    assert dataclasses.asdict(FaultModel()) == dataclasses.asdict(
        JFaultModel())
    kw = dict(flip_prob=0.0008, drop_prob=0.01, delay_prob=0.01,
              crash_prob=0.08, rejoin_prob=0.5, seed=13)
    assert dataclasses.asdict(FaultModel(**kw)) == dataclasses.asdict(
        JFaultModel(**kw))
    # the chain alone injects nothing on the wire
    assert not FaultModel(crash_prob=0.5).any_wire_faults


@pytest.mark.parametrize("kw,match", [
    (dict(crash_prob=1.5), "crash_prob"),
    (dict(rejoin_prob=-0.1), "rejoin_prob"),
    (dict(delay_ms=-1.0), "delay_ms"),
])
def test_fault_model_checks_as_reference(kw, match):
    with pytest.raises(ValueError, match=match):
        JFaultModel(**kw)
    with pytest.raises(ValueError, match=match):
        FaultModel(**kw)


@pytest.mark.parametrize("drop,delay", [(0.0, 0.5), (0.3, 0.3)])
def test_delayed_workers_are_the_wires_late_payloads(drop, delay):
    """``delayed_workers`` draws what the step's FaultyTransport treats as
    late: with no drops its drop mask is exactly the delay draw, and with
    drops it contains it."""
    M = 16
    fm = FaultModel(drop_prob=drop, delay_prob=delay, seed=5)
    late = 0
    for step in range(8):
        d = fm.delayed_workers(step, M, "cpu")
        assert d.dtype == torch.bool and d.shape == (M,)
        t = faulty(StackedTransport(M), fm, step)
        assert isinstance(t, FaultyTransport)
        lost = t.drop_mask("cpu")
        if drop == 0.0:
            assert torch.equal(lost, d)
        else:
            assert bool((lost | ~d).all())
        assert torch.equal(d, fm.delayed_workers(step, M, "cpu"))
        late += int(d.sum())
    assert 0 < late < 8 * M
    assert not bool(FaultModel(delay_prob=0.0).delayed_workers(0, M,
                                                               "cpu").any())
