"""The port's FSDP model and trainer against the reference's FSDP run,
against the port's DP path, and across gloo process groups.

One child process (started by the module fixture, beside everything
else) runs the reference's FSDP train step under ``jax.shard_map`` on 4
host CPU devices (``XLA_FLAGS=--xla_force_host_platform_device_count=4``)
for qwen3-0.6b's SMOKE config, ALQ 3-bit, buckets of 256, SGD without
momentum (so that the momentum after a step is that step's synced
gradient), a level update at step 1, 2 steps.  jax 0.9.0 removed
``batching.BatchTracer``, which ``repro.dist.fsdp._check_not_vmapped``
reads, so the child replaces that guard with a no-op in its own process
(nothing under ``src/repro`` changes).  It saves its numpy weights, the
batches, each step's metrics, synced gradients (every slot, embed and
lm_head shard, and final_norm's mean) and levels.

The port's stacked FSDP trainer (M = 4) starts from the same weights and
replays the reference's keys (``JaxKey``): losses rtol 1e-5; gradients
within 1e-6 of their largest entry (float32 model sums in another order;
a stochastic-rounding tie may move a coordinate by one level step of its
bucket, at no more than 0.1% of them); worker 0's gradient norm within
1e-5 plus the norm of the gradients' difference; the levels after the
update within 1e-4 (ALQ's coordinate descent, ROADMAP §3).

Gloo ranks (2 and 4, ``tests/torch_fsdp_worker.py``) are held bit for
bit against the stacked transport: the reduce-scatters (quantized with
every codec, float32, with error feedback), the error-feedback gather,
and three trainer steps (quantized, two micro-batches, float32) with
their ``state_arrays``.  The float32 FSDP run's losses equal the DP run's
at rtol 1e-5.
"""
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
import torch_fsdp_worker as worker

from repro_torch import configs, weights
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist.transport import StackedTransport
from repro_torch.models.transformer import Model
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLDS = (2, 4)
M_REF, BS_REF, STEPS_REF, LR = 4, 256, 2, 0.05
ARCH = "qwen3-0.6b"

REFERENCE = r'''
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
import repro.dist.fsdp as fsdp_lib
fsdp_lib._check_not_vmapped = lambda shard, axes: None   # gone in jax 0.9
from repro import configs
from repro.core.schemes import QuantScheme
from repro.models import Model
from repro.train.optim import OptimConfig
from repro.train.train_step import (
    TrainConfig, TrainState, init_train_state, make_train_step, metric_specs)
out, arch, M, BS, STEPS, LR = (sys.argv[1], sys.argv[2], int(sys.argv[3]),
                               int(sys.argv[4]), int(sys.argv[5]),
                               float(sys.argv[6]))
SEQ = 32
cfg = configs.get_smoke_config(arch)
mesh = jax.make_mesh((M, 1), ("data", "model"))
scheme = QuantScheme(name="alq", bits=3, bucket_size=BS)
model = Model(cfg, tp=1, dp=M, param_mode="fsdp", fsdp_scheme=scheme,
              fsdp_use_pallas=False)
tcfg = TrainConfig(scheme=scheme, optim=OptimConfig(
    name="sgdm", lr=LR, momentum=0.0, weight_decay=0.0),
    update_milestones=(1,), update_every=0, use_pallas=False)
rng = np.random.default_rng(0)
params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                      model.param_struct())
def fill(a, n):
    a[..., :n] = rng.standard_normal(a[..., :n].shape) * 0.05
for name, (_, shape, _) in (("embed", model._embed_meta[0]),
                            ("lm_head", model._lm_meta[0])):
    fill(params[name], shape[0] * shape[1])
params["final_norm"] = (1.0 + 0.1 * rng.standard_normal(
    params["final_norm"].shape)).astype(np.float32)
for s, meta in enumerate(model._slot_meta):
    fill(params["slots"][s], fsdp_lib.flat_size(meta))
ids = rng.integers(0, cfg.vocab_size, (STEPS, 2 * M, SEQ)).astype(np.int32)
labels = rng.integers(0, cfg.vocab_size, (STEPS, 2 * M, SEQ)).astype(
    np.int32)
pspecs = model.param_specs()
with jax.set_mesh(mesh):
    state = init_train_state(model, tcfg, jax.random.PRNGKey(0))
    state = state._replace(params=jax.tree.map(jnp.asarray, params))
    sspecs = TrainState(
        params=pspecs, opt=type(state.opt)(mu=pspecs, nu=None, count=P()),
        scheme_state=jax.tree.map(lambda _: P(), state.scheme_state),
        step=P(), rng=P(), compress_state=None)
    bspec = {"ids": P("data"), "labels": P("data")}
    train = jax.jit(jax.shard_map(
        make_train_step(model, tcfg), in_specs=(sspecs, bspec),
        out_specs=(sspecs, metric_specs()), check_vma=False))
    res = {"ids": ids, "labels": labels}
    def keep(prefix, tree):
        for k in ("embed", "final_norm", "lm_head"):
            res[f"{prefix}.{k}"] = np.asarray(tree[k])
        for s, leaf in enumerate(tree["slots"]):
            res[f"{prefix}.slots.{s}"] = np.asarray(leaf)
    keep("init", params)
    for t in range(STEPS):
        state, m = train(state, {"ids": jnp.asarray(ids[t]),
                                 "labels": jnp.asarray(labels[t])})
        keep(f"grad{t}", state.opt.mu)   # momentum 0: the synced gradient
        for k, v in m.items():
            res[f"metric{t}.{k}"] = np.asarray(v)
        res[f"levels{t}"] = np.asarray(state.scheme_state.levels)
    keep("final", state.params)
np.savez(out, **res)
print("REFERENCE_OK")
'''


class JaxKey:
    """A port key that replays ``jax.random``: fold is ``fold_in``,
    uniform the reference codec's draw."""

    def __init__(self, key):
        self.key = key

    def fold(self, i):
        return JaxKey(jax.random.fold_in(self.key, i))

    def uniform(self, shape, device):
        return torch.from_numpy(np.array(jax.random.uniform(
            self.key, shape, jnp.float32))).to(device)


def _tree(z, prefix, cfg):
    tree = {k: z[f"{prefix}.{k}"] for k in ("embed", "final_norm",
                                             "lm_head")}
    tree["slots"] = [z[f"{prefix}.slots.{s}"]
                     for s in range(cfg.group_size)]
    return tree


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Starts the reference child and the gloo spawns, computes the
    stacked runs meanwhile, and waits for all."""
    base = tmp_path_factory.mktemp("fsdp")
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    npz = str(base / "reference.npz")
    child = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, npz, ARCH, str(M_REF), str(BS_REF),
         str(STEPS_REF), str(LR)], env=env, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    spawns = {}
    for M in WORLDS:
        path = base / f"world{M}"
        path.mkdir()
        spawns[M] = (path, mp.start_processes(
            worker.spawn_main, args=(M, str(path)), nprocs=M, join=False,
            start_method="spawn"))
    stacked = {}
    for M in WORLDS:
        st = StackedTransport(M)
        inputs = worker.rs_inputs(M)
        stacked[M] = {
            "rs": {n: worker.rs_case(n, inputs["rows"], st)
                   for n in worker.RS_CASES},
            "rs_ef": worker.rs_case("uniform", inputs["rows"], st,
                                    residual=inputs["residual"]),
            "train": {n: worker.train_case(n, st, M)
                      for n in worker.TRAIN_CASES}}
    ranks = {}
    for M, (path, ctx) in spawns.items():
        ctx.join()
        ranks[M] = [torch.load(path / f"rank{r}.pt") for r in range(M)]
    out, err = child.communicate(timeout=600)
    assert child.returncode == 0 and "REFERENCE_OK" in out, err[-4000:]
    return {"stacked": stacked, "ranks": ranks, "reference": np.load(npz)}


def _assert_grad(got, want):
    """Within 1e-6 of the largest entry, but for rounding ties: at most
    0.1% of coordinates, each off by no more than the largest entry."""
    scale = np.abs(want).max()
    err = np.abs(got - want)
    far = err > 1e-6 * scale
    assert far.mean() <= 1e-3, (far.sum(), err.max())
    assert err.max() <= scale, err.max()


def test_fsdp_trainer_matches_reference(runs):
    z = runs["reference"]
    cfg = configs.get_smoke_config(ARCH)
    scheme = QuantScheme(name="alq", bits=3, bucket_size=BS_REF)
    model = Model(cfg, device="cpu", param_mode="fsdp", dp=M_REF,
                  fsdp_scheme=scheme)
    model.load_flat(weights.from_jax_fsdp_params(_tree(z, "init", cfg), cfg,
                                                 BS_REF, M_REF))
    tcfg = TrainConfig(scheme=scheme, optim=OptimConfig(
        name="sgdm", lr=LR, momentum=0.0, weight_decay=0.0),
        update_milestones=(1,), update_every=0, workers=M_REF)
    trainer = Trainer(model, tcfg, key=JaxKey(jax.random.PRNGKey(0)))
    for t in range(STEPS_REF):
        m = trainer.train_step({
            "ids": torch.from_numpy(z["ids"][t]).long(),
            "labels": torch.from_numpy(z["labels"][t]).long()})
        np.testing.assert_allclose(m["loss"], float(z[f"metric{t}.loss"]),
                                   rtol=1e-5)
        for k in ("comm_bits_per_coord", "reduce_bits_per_coord",
                  "broadcast_bits_per_coord", "quant_error"):
            assert m[k] == pytest.approx(float(z[f"metric{t}.{k}"]),
                                         rel=1e-7), k
        want = weights.from_jax_fsdp_params(_tree(z, f"grad{t}", cfg), cfg,
                                            BS_REF, M_REF).numpy()
        got = trainer.opt.mu.numpy()
        _assert_grad(got, want)
        # worker 0's local gradient norm: rtol 1e-5, plus what the ties
        # moved (|‖a‖ - ‖b‖| <= ‖a - b‖)
        gn = float(z[f"metric{t}.grad_norm"])
        assert abs(m["grad_norm"] - gn) <= (
            1e-5 * gn + np.linalg.norm((got - want).astype(np.float64)))
        np.testing.assert_allclose(trainer.scheme_state.levels.numpy(),
                                   z[f"levels{t}"], rtol=0,
                                   atol=1e-5 if t == 0 else 1e-4)
    assert trainer.scheme_state.num_updates == 1
    final = weights.from_jax_fsdp_params(_tree(z, "final", cfg), cfg,
                                         BS_REF, M_REF)
    _assert_grad(model.flat.numpy(), final.numpy())


@pytest.mark.parametrize("M", WORLDS)
def test_gloo_ranks_equal_the_stacked_reduce_scatters(runs, M):
    st = runs["stacked"][M]
    for r, res in enumerate(runs["ranks"][M]):
        assert res["rank"] == r
        for name in worker.RS_CASES:
            assert torch.equal(res["rs"][name][0], st["rs"][name][r]), name
        for got, want in zip(res["rs_ef"], st["rs_ef"]):
            assert torch.equal(got[0], want[r])
        # the EF gather's backward is the reduce-scatter with the residual
        ge = res["gather_ef"]
        assert torch.equal(ge["shard_grad"][0], st["rs_ef"][0][r])
        assert torch.equal(ge["residual"], st["rs_ef"][1][r])
        Lp = worker.rs_inputs(M)["rows"].shape[1]
        assert torch.equal(ge["full"],
                           torch.arange(Lp, dtype=torch.float32) * 1e-4)


@pytest.mark.parametrize("M", WORLDS)
@pytest.mark.parametrize("case", list(worker.TRAIN_CASES))
def test_gloo_ranks_equal_the_stacked_fsdp_trainer(runs, M, case):
    want = runs["stacked"][M]["train"][case]
    for res in runs["ranks"][M]:
        got = res["train"][case]
        assert got["history"] == want["history"]
        assert got["state"].keys() == want["state"].keys()
        for k, v in want["state"].items():
            assert torch.equal(got["state"][k], v), k
    assert all(np.isfinite(h["loss"]) for h in want["history"])


def test_fp32_fsdp_matches_the_dp_run(runs):
    """The float32 FSDP trainer against the DP trainer with the plain
    mean, from the same seed: losses rtol 1e-5, and the FSDP parameters,
    converted to the DP layout, close to the DP run's."""
    M = 2
    fsdp_run = runs["stacked"][M]["train"]["fp32"]
    cfg = configs.get_smoke_config(worker.ARCH)
    model = Model(cfg, device="cpu", seed=0)
    scheme = QuantScheme(name="alq", bits=3, bucket_size=worker.TRAIN_BS)
    tcfg = TrainConfig(scheme=scheme, sync_mode="fp32", optim=OptimConfig(
        name="adamw", lr=1e-3, weight_decay=0.0), update_milestones=(1,),
        update_every=0, workers=M)
    trainer = Trainer(model, tcfg, seed=0)
    pipe = Pipeline(DataConfig(kind="uniform", vocab_size=cfg.vocab_size,
                               seq_len=worker.TRAIN_SEQ, global_batch=2 * M))
    hist = [trainer.train_step(pipe.batch(t, "cpu"))
            for t in range(worker.TRAIN_STEPS)]
    np.testing.assert_allclose([h["loss"] for h in fsdp_run["history"]],
                               [h["loss"] for h in hist], rtol=1e-5)
    dp = weights.fsdp_to_dp(fsdp_run["state"]["params"], cfg,
                            worker.TRAIN_BS, M)
    np.testing.assert_allclose(dp.numpy(), model.flat.numpy(), rtol=0,
                               atol=1e-5)


def test_fsdp_model_equals_the_dp_model_at_the_same_seed():
    """One seed, both modes: the same loss, the same gathered gradient
    (the fp32 reduce-scatter of one worker is the gradient itself), the
    same prefill and decode; the layouts convert both ways."""
    cfg = configs.get_smoke_config("jamba-1.5-large-398b")
    scheme = QuantScheme(name="fp32", bucket_size=128)
    dp = Model(cfg, device="cpu", seed=3)
    fs = Model(cfg, device="cpu", seed=3, param_mode="fsdp", dp=1,
               fsdp_scheme=scheme)
    back = weights.fsdp_to_dp(fs.flat, cfg, 128, 1)
    assert torch.equal(back, dp.flat)
    assert torch.equal(weights.dp_to_fsdp(dp.flat, cfg, 128, 1), fs.flat)
    g = torch.Generator().manual_seed(0)
    ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    labels = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
    grads = []
    for m in (dp, fs):
        row = torch.zeros(m.d, dtype=m.flat.dtype)
        m.attach_grads(row)
        loss = m.loss(ids, labels)
        loss.backward()
        grads.append((loss.detach(), row))
    assert torch.equal(grads[0][0], grads[1][0])
    torch.testing.assert_close(
        weights.fsdp_to_dp(grads[1][1], cfg, 128, 1), grads[0][1],
        rtol=0, atol=0)
    for m in (dp, fs):
        m.prefill_out = m.prefill(ids[:, :16], max_len=20)
    for a, b in zip(dp.prefill_out[1], fs.prefill_out[1]):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    assert torch.equal(dp.prefill_out[0], fs.prefill_out[0])


def test_fsdp_trainer_checkpoint_resumes_and_refuses_stateful_compression(
        tmp_path):
    cfg = configs.get_smoke_config(worker.ARCH)
    scheme = QuantScheme(name="alq", bits=3, bucket_size=worker.TRAIN_BS)

    def make():
        model = Model(cfg, device="cpu", seed=0, param_mode="fsdp", dp=2,
                      fsdp_scheme=scheme)
        return Trainer(model, TrainConfig(
            scheme=scheme, optim=OptimConfig(name="adamw", lr=1e-3),
            update_milestones=(1,), update_every=0, workers=2), seed=0)

    pipe = Pipeline(DataConfig(kind="uniform", vocab_size=cfg.vocab_size,
                               seq_len=16, global_batch=4))
    straight = make()
    hist = [straight.train_step(pipe.batch(t, "cpu")) for t in range(3)]
    first = make()
    first.train_step(pipe.batch(0, "cpu"))
    resumed = make()
    resumed.load_state_arrays(first.state_arrays())
    rest = [resumed.train_step(pipe.batch(t, "cpu")) for t in (1, 2)]
    assert rest == hist[1:]
    assert torch.equal(resumed.model.flat, straight.model.flat)
    model = Model(cfg, device="cpu", param_mode="fsdp", dp=2,
                  fsdp_scheme=scheme)
    with pytest.raises(NotImplementedError, match="gather level"):
        Trainer(model, TrainConfig(scheme=scheme, workers=2, compress="ef"))
