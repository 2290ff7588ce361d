"""The port's scenario engine (``repro_torch.sim.scenario``) and CLI
against the reference's ``repro.sim``.

One cell step of each topology against the reference's jitted cell step
(``_build_cell_step`` on its 1x1 mesh, kernels' plain versions), at a
level-update step of ALQ on ``paper-proxy``: the port gets the
reference's initial weights (``from_jax_params``), the same batch (the
numpy pipeline) and the reference's uniforms, drawn from the step key
fold_in(PRNGKey(seed + 7), t) on the schedule that
``test_torch_sim_topology.py`` states.

Tolerances, each with its reason:
  * loss, agg_err, quant_error, drift_mu and drift_sigma rtol 1e-5
    (float32 sums in another order);
  * levels after the ALQ update atol 1e-4 (ROADMAP section 3: ALQ's
    float32 coordinate descent); psi, taken at the updated levels, when
    the port evaluates it at the reference's levels, within 1e-5 of the
    magnitude of its terms (at adapted levels its closed form cancels to
    a small fraction of them, so float32 noise in the partial moments,
    held at rtol 1e-5 in ``test_torch_levels.py``, shows);
  * the new parameters rtol 1e-5 at 99.9% of the coordinates; AdamW moves
    a coordinate by about lr * sign(g), so where a rounding tie moved one
    code of the aggregate (the reference's |u - rho| < 1e-5) a coordinate
    may move by up to 2 lr more;
  * byte counts, hops and bits/coord exact.

Then: the registry's names and fields equal the reference's; a run's JSON
has the reference's keys (the config less the port's ``layers`` and
``data``); a trajectory is deterministic; the CLI's ``--list`` and
``--out`` work, and it refuses a missing CUDA device.
"""
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.compress import make_algorithm as jmake_algorithm
from repro.models import Model as JModel
from repro.sim import ClusterConfig as JClusterConfig
from repro.sim import SCENARIOS as JSCENARIOS
from repro.sim import Scenario as JScenario
from repro.sim import run_scenario as jrun_scenario
from repro.sim import scenario as jscenario
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import Pipeline as JPipeline
from repro_torch import configs
from repro_torch.compress import make_algorithm
from repro_torch.core.stats import (
    expected_variance, partial_moment0, partial_moment1, partial_moment2)
from repro_torch.dist.sync import gather_stats
from repro_torch.models.transformer import Model
from repro_torch.sim import SCENARIOS, ClusterConfig, Scenario, run_scenario
from repro_torch.sim import __main__ as cli
from repro_torch.sim.scenario import Cell, step_seed
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.weights import from_jax_params
from test_torch_sim_topology import _port_uniforms

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

SEED = 0
M = 4


def _as_reference(scn: Scenario) -> JScenario:
    kw = dataclasses.asdict(scn)
    for k in ("layers", "data"):
        kw.pop(k)
    kw["cluster"] = JClusterConfig(**kw["cluster"])
    return JScenario(**kw)


def _ravel(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree.leaves(tree)])


def _psi_terms(stats, levels):
    """The magnitude of Psi's terms, sum_j |m2| + |a+c| |m1| + |a c| m0
    over the level intervals [a, c]: at adapted levels the closed form
    cancels to a small fraction of it."""
    a, c = levels[:-1], levels[1:]
    m0, m1, m2 = (f(stats, a, c) for f in (
        partial_moment0, partial_moment1, partial_moment2))
    return float(torch.sum(m2.abs() + (a + c).abs() * m1.abs()
                           + (a * c).abs() * m0.abs()))


@pytest.fixture(scope="module")
def weights():
    """The reference's initial parameters of paper-proxy."""
    cfg = jconfigs.get_config("paper-proxy")
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    model = JModel(cfg, tp=1, dp=1)
    with jax.set_mesh(mesh):
        params = jax.jit(model.init)(jax.random.PRNGKey(SEED))
    return model, mesh, params


@pytest.mark.parametrize("topo", ["allreduce", "param_server", "ring"])
def test_cell_step_matches_reference(weights, topo):
    jmodel, mesh, params = weights
    scn = Scenario(name="cell", schemes=("alq",), topologies=(topo,),
                   cluster=ClusterConfig(num_workers=M))
    jscn = _as_reference(scn)
    spec, t = "alq", 0
    jscheme, scheme = jscn.make_scheme(spec), scn.make_scheme(spec)
    jalgo = jmake_algorithm("plain", jscheme)
    step_fn, _ = jscenario._build_cell_step(jmodel, jscheme, jscn, topo,
                                            mesh, False, jalgo)
    data = dict(kind="markov", vocab_size=256, seq_len=scn.seq_len,
                global_batch=scn.batch_per_worker * M, seed=SEED)
    jbatch = JPipeline(JDataConfig(**data)).batch(t)
    key = jax.random.fold_in(jax.random.PRNGKey(SEED + 7), t)
    active = np.ones(M, np.float32)
    st = jscheme.init_state()
    jnp = jax.numpy
    zeros = jax.tree.map(jnp.zeros_like, params)
    d = _ravel(params).size
    with jax.set_mesh(mesh):
        out = step_fn(params, zeros, zeros, jnp.int32(0), st.levels,
                      st.multiplier, st.num_updates, st.entropy_bits,
                      jnp.zeros((M, 0)), jnp.zeros((M,), jnp.int32),
                      jnp.zeros((d,)), jbatch["ids"], jbatch["labels"], key,
                      jnp.bool_(True), jnp.asarray(active), jnp.int32(t))
    jm = out[-1]

    cfg = configs.get_config("paper-proxy")
    model = Model(cfg, device="cpu")
    model.load_flat(from_jax_params(jax.tree.map(np.asarray, params), cfg))
    p0 = model.flat.clone()
    cell = Cell(scn, scheme, topo, make_algorithm("plain", scheme), model)
    u = _port_uniforms(topo, M, model.d, cell.algo.codec, key,
                       scn.server_bits)
    batch = Pipeline(DataConfig(**data)).batch(t, "cpu")
    np.testing.assert_array_equal(batch["ids"].numpy(), jbatch["ids"])
    m = cell.step(batch, active=active, do_update=True, fault_step=t, **u)

    for k in ("loss", "agg_err", "quant_error", "drift_mu", "drift_sigma",
              "grad_norm"):
        np.testing.assert_allclose(m[k], float(jm[k]), rtol=1e-5, err_msg=k)
    jlevels = np.array(jm["levels"])
    np.testing.assert_allclose(m["levels"].numpy(), jlevels, atol=1e-4)
    # psi is taken at the updated levels: held at the reference's levels,
    # since the port's differ by ALQ's float32 noise (above)
    now = gather_stats(cell.grads[:1], scheme)
    lv = torch.from_numpy(jlevels)
    assert abs(float(expected_variance(now, lv)) - float(jm["psi"])) \
        <= 1e-5 * _psi_terms(now, lv)
    assert m["psi"] == float(expected_variance(now, m["levels"]))
    np.testing.assert_array_equal(m["sent_bytes"],
                                  np.asarray(jm["sent_bytes"]))
    np.testing.assert_array_equal(m["recv_bytes"],
                                  np.asarray(jm["recv_bytes"]))
    assert m["server_bytes"] == np.float32(jm["server_bytes"])
    assert m["hops"] == int(jm["hops"])
    assert m["measured_bits_per_coord"] == float(
        jm["measured_bits_per_coord"])
    new = _ravel(out[0])
    got = model.flat.numpy()
    close = np.abs(got - new) <= 1e-5 * np.abs(new)
    assert close.mean() >= 0.999, close.mean()
    assert np.all(np.abs(got - new) <= 2 * scn.lr + 1e-5 * np.abs(new))
    # the cumulative error vector is this step's aggregate error: a
    # moved tie changes a coordinate of it as it does a parameter's step
    cum = np.asarray(out[10])
    close = np.abs(cell.cum_err.numpy() - cum) <= 1e-5 * np.abs(cum).max()
    assert close.mean() >= 0.999, close.mean()
    assert not torch.equal(model.flat, p0)


def test_registry_matches_reference():
    assert sorted(SCENARIOS) == sorted(JSCENARIOS)
    assert len(SCENARIOS) == len(JSCENARIOS) == 12
    for name, scn in SCENARIOS.items():
        assert scn.layers == 0 and scn.data == "markov", name
        assert dataclasses.asdict(_as_reference(scn)) == dataclasses.asdict(
            JSCENARIOS[name]), name


TINY = dict(name="tiny", schemes=("alq",), topologies=("allreduce",),
            steps=1, seq_len=16, batch_per_worker=1,
            update_milestones=(0,))


def _keys(result):
    cell = result["cells"][0]
    return (set(result), set(result["config"]), set(cell),
            set(cell["steps"][0]), set(cell["totals"]))


def test_json_keys_match_reference():
    cluster = dict(num_workers=2, straggler_prob=0.5, straggler_scale=3.0)
    got = run_scenario(Scenario(**TINY, cluster=ClusterConfig(**cluster)),
                       device="cpu")
    want = jrun_scenario(JScenario(**TINY,
                                   cluster=JClusterConfig(**cluster)))
    top, config, cell, step, totals = _keys(got)
    assert config - {"layers", "data"} == _keys(want)[1]
    assert (top, cell, step, totals) == tuple(
        k for i, k in enumerate(_keys(want)) if i != 1)
    # the cost model's numbers are the reference's
    s, js = got["cells"][0]["steps"][0], want["cells"][0]["steps"][0]
    for k in ("wire_sent_bytes", "wire_recv_bytes", "server_bytes", "hops",
              "sim_time_ms", "compute_ms", "active",
              "measured_bits_per_coord"):
        assert s[k] == js[k], k
    assert (got["cells"][0]["fixed_bits_per_coord"]
            == want["cells"][0]["fixed_bits_per_coord"])


def test_trajectory_is_deterministic_and_sane():
    scn = Scenario(name="det", schemes=("alq", "fp32"),
                   topologies=("allreduce", "param_server", "ring"),
                   steps=3, seq_len=16, batch_per_worker=1,
                   update_milestones=(1,),
                   cluster=ClusterConfig(num_workers=4, dropout_prob=0.3,
                                         straggler_prob=0.5,
                                         straggler_scale=2.0))
    r1 = run_scenario(scn, device="cpu")
    r2 = run_scenario(scn, device="cpu")
    assert json.dumps(r1, sort_keys=True) == json.dumps(r2, sort_keys=True)
    cells = {(c["scheme"], c["topology"]): c for c in r1["cells"]}
    for (spec, topo), c in cells.items():
        for s in c["steps"]:
            assert np.isfinite(s["loss"]) and s["sim_time_ms"] > 0
            if spec == "fp32":
                assert s["agg_err"] <= 1e-10 * max(s["grad_norm"], 1) ** 2
        lv = [s["levels"] for s in c["steps"]]
        if spec == "alq":   # the levels move after the milestone only
            assert lv[0] == cells[spec, topo]["steps"][0]["levels"]
            assert lv[1] != lv[0] and lv[2] == lv[1]
    assert any(not all(s["active"]) for c in r1["cells"]
               for s in c["steps"])
    # per-hop re-quantization compounds the error
    ring = cells["alq", "ring"]["totals"]["mean_agg_err"]
    assert ring > cells["alq", "allreduce"]["totals"]["mean_agg_err"]


def test_fault_tolerance_cell_bills_faults_as_reference():
    """The fault_tolerance scenario's faulty cell for a few steps: the
    crash/rejoin events, the staleness weights and the delay billing
    (``delayed_workers`` on the wire's draw) follow the fault model."""
    scn = dataclasses.replace(SCENARIOS["fault_tolerance"], seq_len=16,
                              batch_per_worker=1)
    fm = scn.fault_grid[1]
    fm = dataclasses.replace(fm, crash_prob=0.5, delay_prob=0.5)
    scn = dataclasses.replace(scn, fault_grid=(fm,))
    r = run_scenario(scn, steps=4, device="cpu")
    cell = r["cells"][0]
    from repro_torch.sim import cluster
    state = cluster.init_cluster_state(4)
    events = []
    for t, s in enumerate(cell["steps"]):
        compute, active = cluster.sample_step(scn.cluster, t)
        state, weight, ev = cluster.step_faults(fm, state, t)
        events += ev
        assert s["active_weight"] == [float(a) for a in active * weight]
        dt = cluster.step_time_ms(
            scn.cluster, compute, active * weight,
            np.asarray(s["wire_sent_bytes"]),
            np.asarray(s["wire_recv_bytes"]), s["server_bytes"], s["hops"])
        late = fm.delayed_workers(t, 4, "cpu").numpy()
        if late[(active * weight) > 0].any():
            dt += fm.delay_ms
        assert s["sim_time_ms"] == dt
        assert np.isfinite(s["loss"])
    assert cell["fault_events"] == events and events
    assert cell["fault"] == dataclasses.asdict(fm)
    assert cell["totals"]["mean_corrupt_fraction"] > 0


def test_cli_list_out_and_device(tmp_path, capsys):
    assert cli.main(["--list"]) == 0
    listed = capsys.readouterr().out
    for name in SCENARIOS:
        assert name in listed
    out = tmp_path / "sim.json"
    assert cli.main(["--scenario", "ef_vs_plain", "--steps", "2",
                     "--workers", "2", "--out", str(out),
                     "--device", "cpu"]) == 0
    result = json.loads(out.read_text())
    assert result["scenario"] == "ef_vs_plain"
    assert result["num_steps"] == 2
    assert len(result["cells"]) == 2
    assert all(len(c["steps"]) == 2 for c in result["cells"])
    assert all(len(c["steps"][0]["wire_sent_bytes"]) == 2
               for c in result["cells"])
    assert "wrote" in capsys.readouterr().out
    assert cli.main(["--scenario", "nope"]) == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--scenario", "paper_mlp", "--out",
                      str(tmp_path / "x.json")])


def test_step_seed_is_per_step():
    seeds = {step_seed(0, t) for t in range(50)}
    assert len(seeds) == 50
    assert step_seed(0, 3) == step_seed(0, 3) != step_seed(1, 3)
