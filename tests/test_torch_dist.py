"""The port over a torch.distributed process group, one worker a process,
against the same calls on the stacked transport and against the
reference.

Each world size (2 and 4 gloo ranks on the CPU) is one spawn of
``torch_dist_worker.spawn_main`` through a ``file://`` store under the
test's temporary directory (so that parallel test workers never race for
a port), which runs every case and saves each rank's results.  The
launcher runs under ``python -m torch.distributed.run --standalone
--nproc-per-node 2``.  Everything starts at once in ``runs``; the parent
computes the stacked results and the reference's while the children run.

Held bit for bit against the stacked transport at the same M, on every
rank: the collectives; each sync case's aggregate, the rank's own round
trip (or residual row), the levels and every ``SyncMetrics`` field, the
per-worker fields as all M workers' vectors (the fp32 mode at 4 ranks
within rtol 1e-6: the all-reduce adds in its own order); three trainer
steps' metrics, parameters and ``state_arrays``; the launcher's losses,
parameters and checkpoint files, and a checkpoint of either form resumed
in the other.  all_gather and two_phase are also held against the
reference's ``quantized_allreduce`` under ``jax.vmap`` with its own
uniforms, with ``test_torch_codec_sync.py``'s and
``test_torch_two_phase.py``'s tolerances.
"""
import json
import os
import shutil
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_dist_worker as worker
from test_torch_two_phase import (
    KEY, PHASE2_FOLD, _codecs, _reference_two_phase, _uniforms,
    assert_tie_rule)

from repro.dist import sync as jsync
from repro_torch.dist.transport import StackedTransport
from repro_torch.launch import train
from repro_torch.train import checkpoint

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

WORLDS = (2, 4)
JAX_CASES = ("all_gather", "two_phase")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEADLINE_S = 300
# the launcher's run: two_phase + ef + integrity, a level update at step 1
LAUNCH = ["--device", "cpu", "--arch", "paper-proxy", "--steps", "3",
          "--update-at", "1", "--seq", "16", "--batch", "4", "--sync",
          "two_phase", "--compress", "ef", "--integrity"]
TORCHRUN = [sys.executable, "-m", "torch.distributed.run", "--standalone",
            "--nproc-per-node", "2"]


def _inputs(M: int) -> dict:
    """Each sync case's (M, d) gradients, per-worker uniforms and residual
    rows; the reference's draws for ``JAX_CASES``."""
    rng = np.random.default_rng(M)
    g = torch.Generator().manual_seed(M)
    out = {}
    for name, case in worker.SYNC_CASES.items():
        scale = np.exp(rng.standard_normal((M, 1)))
        grads = (rng.standard_normal((M, worker.D)) * 1e-2 * scale)
        codec = worker.algorithm_of(case).codec
        two = case["mode"] == "two_phase"
        plan = codec.plan(worker.D, shards=M if two else 1)
        if name in JAX_CASES:
            u = [_uniforms(jax.random.fold_in(KEY, w), (plan.nb, worker.BS))
                 for w in range(M)]
            u2 = [_uniforms(jax.random.fold_in(jax.random.fold_in(KEY, r),
                                               PHASE2_FOLD),
                            (plan.shard_nb, worker.BS)) for r in range(M)]
        else:
            u = [torch.rand(codec.rounding_shape(plan.nb), generator=g)
                 for _ in range(M)]
            u2 = [torch.rand((plan.shard_nb, worker.BS), generator=g)
                  for _ in range(M)]
        out[name] = {
            "grads": torch.from_numpy(grads.astype(np.float32)),
            "u": u, "u2": u2 if two else None,
            "residual": torch.randn((M, worker.D), generator=g) * 1e-3}
    return out


def _torchrun(args: list[str], cwd) -> subprocess.Popen:
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        [os.path.join(ROOT, "src"), os.path.join(ROOT, "tests")]))
    return subprocess.Popen(TORCHRUN + args, cwd=cwd, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE)


def _launch(argv: list[str]) -> dict:
    return train.run(train.parse_args(LAUNCH + argv))


def _finish(proc: subprocess.Popen) -> tuple[int, str, str]:
    try:
        out, err = proc.communicate(timeout=DEADLINE_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
    return proc.returncode, out, err


def _reference_all_gather(grads):
    jscheme, _, jc, _ = _codecs(False, bs=worker.BS)
    jstate = jscheme.init_state()

    def one(g):
        return jsync.quantized_allreduce(g, jscheme, jstate, KEY,
                                         axes=("w",), use_pallas=False,
                                         codec=jc, return_own=True)

    return jax.jit(jax.vmap(one, axis_name="w"))(jnp.asarray(grads))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("dist")
    spawns = {}
    for M in WORLDS:
        path = base / f"world{M}"
        path.mkdir()
        inputs = _inputs(M)
        torch.save(inputs, path / "inputs.pt")
        spawns[M] = (path, inputs, mp.start_processes(
            worker.spawn_main, args=(M, str(path)), nprocs=M, join=False,
            start_method="spawn"))

    # the launcher: the stacked run first, whose step-1 checkpoint the
    # second torchrun resumes
    stacked_dir, resumed_dir = base / "stacked", base / "from_stacked"
    straight = _launch(["--workers", "2", "--ckpt-dir", str(stacked_dir),
                        "--save-every", "1", "--save",
                        str(stacked_dir / "params.npz")])
    resumed_dir.mkdir()
    shutil.copy(checkpoint.step_path(str(stacked_dir), 1), resumed_dir)
    ranks_dir = base / "ranks"
    ranks_dir.mkdir()
    procs = {
        "ranks": _torchrun(
            [os.path.join(ROOT, "tests", "torch_dist_worker.py"), "launch",
             str(ranks_dir), *LAUNCH, "--backend", "gloo", "--ckpt-dir",
             str(ranks_dir), "--save-every", "1", "--save",
             str(ranks_dir / "params.npz")], base),
        "from_stacked": _torchrun(
            ["-m", "repro_torch.launch.train", *LAUNCH, "--backend", "gloo",
             "--ckpt-dir", str(resumed_dir), "--save",
             str(resumed_dir / "params.npz")], base),
        "workers3": _torchrun(["-m", "repro_torch.launch.train", *LAUNCH,
                               "--workers", "3"], base),
        "nccl_cpu": _torchrun(["-m", "repro_torch.launch.train", *LAUNCH,
                               "--backend", "nccl"], base)}

    stacked = {M: {
        "sync": {name: worker.run_case(case, inputs[name],
                                       StackedTransport(M))
                 for name, case in worker.SYNC_CASES.items()},
        "train": {name: worker.train_case(case, StackedTransport(M), M)
                  for name, case in worker.TRAIN_CASES.items()},
        "transport": worker.transport_case(StackedTransport(M), M),
        "reference": {"all_gather": _reference_all_gather(
            inputs["all_gather"]["grads"].numpy()),
            "two_phase": _reference_two_phase(
                *_codecs(False, bs=worker.BS)[::2],
                inputs["two_phase"]["grads"].numpy())}}
        for M, (_, inputs, _) in spawns.items()}

    launches = {name: _finish(p) for name, p in procs.items()}
    # a checkpoint of the two ranks, resumed stacked
    to_stacked = base / "to_stacked"
    to_stacked.mkdir()
    if launches["ranks"][0] == 0:
        shutil.copy(checkpoint.step_path(str(ranks_dir), 1), to_stacked)
    back = _launch(["--workers", "2", "--ckpt-dir", str(to_stacked)])

    children = {}
    t0 = time.monotonic()
    for M, (path, _, ctx) in spawns.items():
        while not ctx.join(timeout=5):
            if time.monotonic() - t0 > DEADLINE_S:
                for p in ctx.processes:
                    p.kill()
                pytest.fail(f"the {M} spawned ranks did not finish")
        children[M] = [torch.load(path / f"rank{r}.pt") for r in range(M)]
    return {"children": children, "stacked": stacked, "straight": straight,
            "inputs": {M: inputs for M, (_, inputs, _) in spawns.items()},
            "back": back, "launches": launches, "dirs": {
                "stacked": stacked_dir, "ranks": ranks_dir,
                "from_stacked": resumed_dir}}


def _assert_same(got, want, what):
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _assert_same(got[k], want[k], f"{what}.{k}")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), what
        for i, (a, b) in enumerate(zip(got, want)):
            _assert_same(a, b, f"{what}[{i}]")
    elif isinstance(want, torch.Tensor):
        assert got.dtype == want.dtype and got.shape == want.shape, what
        assert torch.equal(got, want), what
    else:
        assert got == want, what


@pytest.mark.parametrize("M", WORLDS)
def test_collectives_equal_the_stacked_transport(runs, M):
    want = runs["stacked"][M]["transport"]
    for r, child in enumerate(runs["children"][M]):
        assert child["rank"] == r and child["local"] == [r]
        got = child["transport"]
        for k in ("all_gather", "scalars", "bytes"):
            _assert_same(got[k], want[k], k)
        # all_to_all: [local receiver, sender], this rank's row
        _assert_same(got["all_to_all"], want["all_to_all"][r:r + 1],
                     "all_to_all")
        torch.testing.assert_close(got["mean_psum"], want["mean_psum"],
                                   rtol=1e-6 if M > 2 else 0, atol=0)


@pytest.mark.parametrize("name", list(worker.SYNC_CASES))
@pytest.mark.parametrize("M", WORLDS)
def test_sync_equals_the_stacked_transport(runs, M, name):
    want = runs["stacked"][M]["sync"][name]
    for r, got in enumerate(runs["children"][M]):
        got = got["sync"][name]
        if name == "fp32" and M > 2:
            # the all-reduce adds in its own order: within 1e-6 of the
            # terms' magnitude (the sum may cancel)
            terms = runs["inputs"][M][name]["grads"].abs().mean(0)
            assert bool(((got["out"] - want["out"]).abs()
                         <= 1e-6 * terms).all())
        else:
            _assert_same(got["out"], want["out"], "out")
        for k in ("own", "residual"):
            if k in want:
                _assert_same(got[k], want[k][r:r + 1], k)
        _assert_same(got["levels"], want["levels"], "levels")
        _assert_same(got["metrics"], want["metrics"], "metrics")
    if name.startswith("faults"):     # the wire was corrupted
        assert float(want["metrics"]["corrupt_fraction"][0]) > 0
    if name == "level_update":
        assert not torch.equal(want["levels"],
                               worker.SCHEME.init_state("cpu").levels)


@pytest.mark.parametrize("name", JAX_CASES)
@pytest.mark.parametrize("M", WORLDS)
def test_sync_matches_the_vmapped_reference(runs, M, name):
    jout, jown, jm = runs["stacked"][M]["reference"][name]
    for child in runs["children"][M]:
        got = child["sync"][name]
        out = got["out"].numpy()
        if name == "all_gather":
            scale = np.mean(np.abs(np.asarray(jown)), axis=0)
            for w in range(M):
                err = np.abs(out - np.asarray(jout[w]))
                assert np.all(err <= 1e-6 * scale + 1e-12), err.max()
        else:
            for w in range(M):
                assert_tie_rule(out, np.asarray(jout[w]), worker.BS)
        np.testing.assert_allclose(got["metrics"]["quant_error"].numpy(),
                                   np.asarray(jm.quant_error), rtol=1e-5)
        assert got["metrics"]["comm_bits_per_coord"] == pytest.approx(
            float(jm.comm_bits_per_coord[0]), rel=1e-7)


@pytest.mark.parametrize("name", list(worker.TRAIN_CASES))
@pytest.mark.parametrize("M", WORLDS)
def test_trainer_equals_the_stacked_trainer(runs, M, name):
    want = runs["stacked"][M]["train"][name]
    assert want["history"][1]["loss"] != want["history"][0]["loss"]
    for child in runs["children"][M]:
        _assert_same(child["train"][name], want, name)


def _arrays(path):
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def _assert_same_file(got, want):
    a, b = _arrays(got), _arrays(want)
    assert set(a) == set(b)
    for k in b:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_launcher_under_torchrun_equals_the_stacked_workers(runs):
    rc, out, err = runs["launches"]["ranks"]
    assert rc == 0, err[-3000:]
    straight = runs["straight"]
    dirs = runs["dirs"]
    want = [h["loss"] for h in straight["history"]]
    digest = train.params_digest(straight["trainer"].model.flat)
    for r in range(2):
        with open(dirs["ranks"] / f"launch_rank{r}.json") as f:
            got = json.load(f)
        assert got["loss"] == want and got["step"] == [0, 1, 2]
        assert got["digest"] == digest
    # rank 0 alone logs, and writes the stacked run's files
    assert out.count("done: 3 steps") == 1
    for step in range(3):
        _assert_same_file(checkpoint.step_path(str(dirs["ranks"]), step),
                          checkpoint.step_path(str(dirs["stacked"]), step))
    _assert_same_file(dirs["ranks"] / "params.npz",
                      dirs["stacked"] / "params.npz")


def test_checkpoints_resume_across_the_two_forms(runs):
    # stacked at step 1 -> two ranks, resumed at step 2
    rc, out, err = runs["launches"]["from_stacked"]
    assert rc == 0, err[-3000:]
    dirs = runs["dirs"]
    assert "resumed step 1 from" in out
    _assert_same_file(checkpoint.step_path(str(dirs["from_stacked"]), 2),
                      checkpoint.step_path(str(dirs["stacked"]), 2))
    _assert_same_file(dirs["from_stacked"] / "params.npz",
                      dirs["stacked"] / "params.npz")
    # two ranks at step 1 -> stacked
    back, straight = runs["back"], runs["straight"]
    assert [h["step"] for h in back["history"]] == [2]
    assert back["history"][0]["loss"] == straight["history"][2]["loss"]
    assert torch.equal(back["trainer"].model.flat,
                       straight["trainer"].model.flat)


@pytest.mark.parametrize("name,message", [
    ("workers3", "--workers 3 under 2 ranks"),
    ("nccl_cpu", "the NCCL backend moves CUDA tensors only")])
def test_launcher_refuses_what_a_group_cannot_run(runs, name, message):
    rc, out, err = runs["launches"][name]
    assert rc != 0 and message in err, err[-3000:]


def test_launcher_refuses_a_backend_without_a_group():
    with pytest.raises(ValueError, match="needs a process group"):
        _launch(["--backend", "gloo"])
