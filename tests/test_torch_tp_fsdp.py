"""FSDP under tensor parallelism against the reference's FSDP train step
on a (data x model) = (2, 2) mesh.

A reference child (``tests/torch_tp_reference.py fsdp``, on 4 host CPU
devices, with ``repro.dist.fsdp._check_not_vmapped`` patched out in that
child only, as ``test_torch_fsdp_model.py`` does) runs
``make_train_step`` of ``Model(cfg, tp=2, dp=2, param_mode="fsdp")`` for
qwen3-0.6b's SMOKE config from its own init: ALQ 3-bit, buckets of 256,
SGD without momentum, a level update at step 1, 2 steps, keeping each
device's loss, synced gradient shard (raveled inside shard_map) and
levels.  Two gloo ranks (``tests/torch_tp_worker.py``) hold the two
model ranks, each with the two data workers stacked (so this also covers
stacked data workers under TP: every model rank runs both workers'
forwards in the same order), each model rank's flat
``weights.from_jax_fsdp_params(tree, cfg, 256, 2, tp=2, rank)``, and the
reference's keys (``JaxKey``):

  * losses rtol 1e-5;
  * each worker's synced gradient shard within 1e-6 of its largest entry
    but for rounding ties (at most 0.1% of coordinates; the update at
    step 1 comes after that step's reduce-scatter, so the words use the
    same levels);
  * levels within 1e-5 before the update and 1e-4 after it;
  * ``state_arrays`` the same on both ranks, in the reference's global
    FSDP layout ((tp, Lp) embed and lm_head, (G, tp, Lp) slots);
  * model ranks that hold unequal numbers of stacked workers are
    refused.
"""
import json
import os
import subprocess
import sys
import time

import jax
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_tp_worker as worker
from test_torch_fsdp_model import _assert_grad

from repro import configs as jconfigs
from repro.core.schemes import QuantScheme as JScheme
from repro.models import Model as JModel
from repro_torch import configs
from repro_torch.models.transformer import final_norm_slice, from_global

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 600
ARCH = "qwen3-0.6b"
CASE = {"name": "fsdp", "arch": ARCH, "tp": 2, "dp": 2, "steps": 2,
        "seq": 32, "bs": 256, "lr": 0.05}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp_fsdp")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_tp_reference.py"),
         "fsdp", str(base / "fsdp.npz"), json.dumps([CASE])], env=env,
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out, err = ref.communicate(timeout=DEADLINE_S)
    assert ref.returncode == 0 and "REFERENCE_OK" in out, err[-4000:]
    torch.save({"fsdp": [CASE]}, base / "job.pt")
    ctx = mp.start_processes(worker.spawn_fsdp, args=(2, str(base)),
                             nprocs=2, join=False, start_method="spawn")
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > DEADLINE_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the spawned ranks did not finish")
    ranks = [torch.load(base / f"rank{r}.pt") for r in range(2)]
    return {"reference": np.load(base / "fsdp.npz"),
            "ranks": [r["fsdp"] for r in ranks],
            "uneven": [r.get("uneven") for r in ranks]}


def test_fsdp_under_tp_matches_the_reference(runs):
    z, name = runs["reference"], CASE["name"]
    for m, res in enumerate(runs["ranks"]):
        for t, step in enumerate(res["steps"]):
            for w in range(CASE["dp"]):
                np.testing.assert_allclose(
                    step["metrics"]["loss"], z[f"{name}.loss{t}"][w, m],
                    rtol=1e-5)
                _assert_grad(step["mu"][w].numpy(), z[f"{name}.mu{t}"][w, m])
                np.testing.assert_allclose(
                    step["levels"].numpy(), z[f"{name}.levels{t}"][w, m],
                    rtol=0, atol=1e-5 if t == 0 else 1e-4)


def test_unequal_stacked_workers_across_the_model_group_raise(runs):
    """Every worker's forward issues the model group's collectives, so a
    model rank holding 1 stacked worker and one holding 2 would hang:
    the trainer refuses them on both ranks."""
    for msg in runs["uneven"]:
        assert msg is not None and "[1, 2] data workers" in msg


def test_fsdp_state_gathers_to_the_reference_layout(runs):
    cfg = configs.get_smoke_config(ARCH)
    states = [r["state"] for r in runs["ranks"]]
    assert states[0].keys() == states[1].keys()
    for k in states[0]:
        assert torch.equal(states[0][k], states[1][k]), k
    scheme = JScheme(name="alq", bits=3, bucket_size=CASE["bs"])
    shapes = jax.eval_shape(JModel(
        jconfigs.get_smoke_config(ARCH), tp=2, dp=2, param_mode="fsdp",
        fsdp_scheme=scheme).init, jax.random.PRNGKey(0))
    assert states[0]["params"].shape == (sum(
        int(np.prod(x.shape)) for x in jax.tree.leaves(shapes)),)
    kw = {"fsdp": (CASE["bs"], CASE["dp"])}
    fn = final_norm_slice(cfg, 2, **kw)
    for m in range(2):
        mu = from_global(states[0]["opt.mu"], cfg, 2, m, **kw)
        mu[fn] = states[0]["opt.mu.final_norm"][m]
        # the stacked workers' buffer is the model rank's whole layout
        assert torch.equal(mu, runs["ranks"][m]["steps"][-1]["mu_all"])
