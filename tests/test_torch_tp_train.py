"""The trainer on a (data x model) grid against the reference's train
step, and ``--tp`` through the launcher.

A reference child (``tests/torch_tp_reference.py train``, on 4 host CPU
devices) runs ``make_train_step`` under ``jax.shard_map`` on a
(dp, tp) = (2, 2) mesh for qwen3-0.6b's SMOKE config from its own
``Model(cfg, tp=2).init``: ALQ 3-bit, buckets of 256, SGD without
momentum (the momentum after a step is the synced gradient), a level
update at step 1, 2 steps.  It keeps each device's loss, synced gradient
flat (raveled inside shard_map) and levels after every step, and the
uniforms of each data rank.  Four gloo ranks (``tests/torch_tp_worker.py``)
run the port's trainer on ``mesh.init_grid(2)``, each with its model
rank's weights (``weights.from_jax_params``) and its data rank's
uniforms:

  * losses rtol 1e-5 (the float32 model sums in other orders);
  * levels within 1e-5 before the update and 1e-4 after it (ALQ's float32
    coordinate descent, ROADMAP §3);
  * synced gradients: at step 0 within 1e-6 of their largest entry, but
    for stochastic-rounding ties: at most 0.1% of coordinates, each off
    by no more than the largest entry
    (``test_torch_fsdp_model._assert_grad``); at step 1, after the
    update, each coordinate within its workers' largest bucket norm
    times (the levels' difference + 1e-5), but at no more than 0.5% of
    coordinates (the roundings that the levels' difference moves across
    u, as in ``test_torch_train``), off by one level step more;
  * the replicated leaves' gradients and the levels differ across the
    model axis after the update, in the reference and in the port, and
    the two data ranks of each model rank hold the same state.

The launcher at ``--tp 2`` under torchrun (4 ranks): a run of 3 steps
against a run resumed from its step-1 checkpoint, bit for bit; the
checkpoint's parameters in the reference's global layout (its tree's
shapes, each model rank's shards along the tp axis); and the refusals of
a tp that does not divide the world and of ``--tp`` without a group.
"""
import json
import os
import shutil
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
from repro.models import Model as JModel
from repro_torch import configs
from repro_torch.launch import train
from repro_torch.models.transformer import (
    final_norm_slice, from_global, param_layout)
from repro_torch.train import checkpoint

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 600
ARCH = "qwen3-0.6b"
CASE = {"name": "grid", "arch": ARCH, "tp": 2, "dp": 2, "steps": 2,
        "seq": 32, "bs": 256, "lr": 0.05}
LAUNCH = ["--device", "cpu", "--arch", ARCH, "--smoke", "--tp", "2",
          "--steps", "3", "--update-at", "1", "--seq", "16", "--batch", "4",
          "--bucket", "256"]
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "4"]


def _env(**extra):
    return dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]), **extra)


def _torchrun(args, cwd):
    return subprocess.Popen(TORCHRUN + args, cwd=cwd, env=_env(), text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def _launch_argv(out_dir, *extra):
    return [os.path.join(ROOT, "tests", "torch_tp_worker.py"), "launch",
            str(out_dir), *LAUNCH, "--backend", "gloo", *extra]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("tp_train")
    ref = subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "tests", "torch_tp_reference.py"),
         "train", str(base / "train.npz"), json.dumps([CASE])],
        env=_env(JAX_PLATFORMS="cpu",
                 XLA_FLAGS="--xla_force_host_platform_device_count=4"),
        text=True, stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    straight, resumed = base / "straight", base / "resumed"
    straight.mkdir()
    resumed.mkdir()
    procs = {"straight": _torchrun(_launch_argv(
        straight, "--ckpt-dir", str(straight), "--save-every", "1",
        "--save", str(straight / "params.npz")), base),
        "tp3": _torchrun(["-m", "repro_torch.launch.train", *LAUNCH,
                          "--tp", "3"], base)}
    out, err = ref.communicate(timeout=DEADLINE_S)
    assert ref.returncode == 0 and "REFERENCE_OK" in out, err[-4000:]
    torch.save({"train": [CASE]}, base / "job.pt")
    ctx = mp.start_processes(worker.spawn_train, args=(4, str(base)),
                             nprocs=4, join=False, start_method="spawn")
    launches = {"straight": _finish(procs.pop("straight"))}
    if launches["straight"][0] == 0:
        shutil.copy(checkpoint.step_path(str(straight), 1), resumed)
    procs["resumed"] = _torchrun(_launch_argv(
        resumed, "--ckpt-dir", str(resumed), "--save",
        str(resumed / "params.npz")), base)
    t0 = time.monotonic()
    while not ctx.join(timeout=5):
        if time.monotonic() - t0 > DEADLINE_S:
            for p in ctx.processes:
                p.kill()
            pytest.fail("the spawned ranks did not finish")
    launches.update({k: _finish(p) for k, p in procs.items()})
    return {"reference": np.load(base / "train.npz"),
            "ranks": [torch.load(base / f"rank{r}.pt") for r in range(4)],
            "launches": launches, "dirs": {"straight": straight,
                                           "resumed": resumed}}


def _assert_synced(got, want, rows, lv, jlv):
    """The synced gradient after a level update: each value is a level
    times a worker's bucket norm, averaged, so levels that differ by dlev
    move a coordinate by at most its workers' largest bucket norm times
    (dlev + 1e-5); a stochastic rounding whose |u - rho| sits within what
    dlev moves rho may go the other way, at no more than 0.5% of
    coordinates (as in ``test_torch_train``), by one level step more."""
    bs = CASE["bs"]
    d = want.shape[0]
    pad = torch.nn.functional.pad(rows, (0, -d % bs))
    norms = torch.linalg.vector_norm(pad.reshape(rows.shape[0], -1, bs),
                                     dim=2).max(0).values
    scale = norms.repeat_interleave(bs)[:d].numpy()
    dlev = np.abs(lv - jlv).max()
    diff = np.abs(got - want)
    close = diff <= scale * (dlev + 1e-5)
    print(f"levels' difference {dlev:.3g}: {1 - close.mean():.4%} of "
          f"{d} coordinates moved across u")
    assert close.mean() >= 0.995, close.mean()
    assert np.all(diff <= scale * (np.diff(jlv).max() + dlev + 1e-5))


def test_trainer_on_the_grid_matches_the_reference(runs):
    """Step 0 (levels not yet updated): the synced gradient within 1e-6
    of its largest entry but for ties; step 1 (after the update): within
    what the levels' difference allows (``_assert_synced``)."""
    z, name = runs["reference"], CASE["name"]
    by = {(r["grid"]["data"], r["grid"]["model"]): r["grid"]["steps"]
          for r in runs["ranks"]}
    for (d, m), steps in by.items():
        for t, step in enumerate(steps):
            np.testing.assert_allclose(step["metrics"]["loss"],
                                       z[f"{name}.loss{t}"][d, m], rtol=1e-5)
            lv, jlv = step["levels"].numpy(), z[f"{name}.levels{t}"][d, m]
            np.testing.assert_allclose(lv, jlv, rtol=0,
                                       atol=1e-5 if t == 0 else 1e-4)
            got, want = step["mu"].numpy(), z[f"{name}.mu{t}"][d, m]
            if t == 0:
                _assert_grad(got, want)
            else:
                rows = torch.stack([by[w, m][t]["grads"] for w in range(2)])
                _assert_synced(got, want, rows, lv, jlv)


def test_model_ranks_train_apart_and_data_ranks_together(runs):
    """After the update at step 1 each model rank has its own levels and
    its own replicated leaves' gradient (in both packages); the two data
    ranks of a model rank hold the same synced gradient and levels."""
    z, name = runs["reference"], CASE["name"]
    cfg = configs.get_smoke_config(ARCH)
    fn = final_norm_slice(cfg, 2)
    by = {(r["grid"]["data"], r["grid"]["model"]): r["grid"]["steps"][-1]
          for r in runs["ranks"]}
    for m in range(2):
        assert torch.equal(by[0, m]["mu"], by[1, m]["mu"])
        assert torch.equal(by[0, m]["levels"], by[1, m]["levels"])
    assert not np.array_equal(z[f"{name}.levels1"][0, 0],
                              z[f"{name}.levels1"][0, 1])
    assert not torch.equal(by[0, 0]["levels"], by[0, 1]["levels"])
    assert not np.array_equal(z[f"{name}.mu1"][0, 0][fn],
                              z[f"{name}.mu1"][0, 1][fn])
    assert not torch.equal(by[0, 0]["mu"][fn], by[0, 1]["mu"][fn])


def test_trainer_state_gathers_to_the_reference_layout(runs):
    """Every rank's ``state_arrays`` is the same, the parameters in the
    reference's global layout, each model rank's shards and its own
    final_norm in it."""
    cfg = configs.get_smoke_config(ARCH)
    states = [r["grid"]["state"] for r in runs["ranks"]]
    for s in states[1:]:
        assert s.keys() == states[0].keys()
        for k in s:
            assert torch.equal(s[k], states[0][k]), k
    shapes = jax.eval_shape(JModel(jconfigs.get_smoke_config(ARCH), tp=2,
                                   dp=2).init, jax.random.PRNGKey(0))
    size = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    st = states[0]
    assert st["params"].shape == (size,)
    fn = final_norm_slice(cfg, 2)
    assert st["params.final_norm"].shape == (2, cfg.d_model)
    assert st["scheme.levels"].shape[0] == 2
    for m in range(2):
        mine = from_global(st["params"], cfg, 2, m)
        assert mine.shape == (sum(int(np.prod(s)) for _, s, _ in
                                  param_layout(cfg, 2)),)
        mine[fn] = st["params.final_norm"][m]
        mu = from_global(st["opt.mu"], cfg, 2, m)
        mu[fn] = st["opt.mu.final_norm"][m]
        last = next(r for r in runs["ranks"] if r["grid"]["model"] == m)
        assert torch.equal(mu, last["grid"]["steps"][-1]["mu"])


def test_launcher_at_tp2_resumes_bit_for_bit(runs):
    launches = runs["launches"]
    for k in ("straight", "resumed"):
        rc, out, err = launches[k]
        assert rc == 0, err[-3000:]
    out = launches["straight"][1]
    assert "step    0 loss=" in out and "step    2 loss=" in out
    assert "resumed step 1" in launches["resumed"][1]
    a = np.load(runs["dirs"]["straight"] / "params.npz")["params"]
    b = np.load(runs["dirs"]["resumed"] / "params.npz")["params"]
    np.testing.assert_array_equal(a, b)
    shapes = jax.eval_shape(JModel(jconfigs.get_smoke_config(ARCH), tp=2,
                                   dp=2).init, jax.random.PRNGKey(0))
    assert a.size == sum(int(np.prod(x.shape))
                         for x in jax.tree.leaves(shapes))
    for d in ("straight", "resumed"):
        ranks = [torch.load(runs["dirs"][d] / f"rank{r}.pt")
                 for r in range(4)]
        assert [r["model"] for r in ranks] == [0, 1, 0, 1]
        # each model rank's flat: its shards of the saved global layout
        cfg = configs.get_smoke_config(ARCH)
        fn = final_norm_slice(cfg, 2)
        for i, r in enumerate(ranks):
            mine = from_global(torch.from_numpy(a), cfg, 2, i % 2)
            keep = torch.ones_like(mine, dtype=torch.bool)
            if i % 2:
                keep[fn] = False    # the saved final_norm is rank 0's
            assert torch.equal(mine[keep], r["flat"][keep])
        assert [h["loss"] for h in ranks[0]["history"]] == [
            h["loss"] for h in ranks[1]["history"]]
    straight = torch.load(runs["dirs"]["straight"] / "rank0.pt")["history"]
    resumed = torch.load(runs["dirs"]["resumed"] / "rank0.pt")["history"]
    assert [h["loss"] for h in straight[2:]] == [h["loss"] for h in resumed]


def test_launcher_refuses_a_tp_that_does_not_divide_the_world(runs):
    rc, _, err = runs["launches"]["tp3"]
    assert rc != 0 and "does not divide the world of 4" in err


def test_launcher_refuses_tp_without_a_group():
    with pytest.raises(ValueError, match="--tp needs a process group"):
        train.run(train.parse_args(["--device", "cpu", "--tp", "2"]))
