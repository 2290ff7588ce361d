"""The whole slice: the port's train step against the reference's.

One step of ``paper-proxy`` with M=1 on the reference's 1x1 mesh (as in
``test_train_integration.py``), at a level-update step, with SGD-momentum;
the reference runs its kernels' plain versions (``use_pallas=False``),
which ``test_torch_kernels.py`` holds against the Pallas kernels.
The port gets the reference's initial weights (``from_jax_params``), the
same batch (the numpy pipeline) and the reference's uniforms, which the
train step draws from fold_in(fold_in(fold_in(PRNGKey(0), step), rank),
rank) (``train_step.py`` folds in the step and the data rank, and
``quantized_allreduce`` the rank again).

Tolerances, each with its reason:
  * loss rtol 1e-5: float32 forward, sums in another order;
  * levels atol 1e-4: ALQ's float32 coordinate descent (see
    ``test_torch_levels.py``);
  * new parameters: the update is lr * Q(g), and each value of Q(g) is
    a level times its bucket's norm.  With levels that differ by dlev
    (above), a coordinate may differ by lr * norm * (dlev + 1e-5); a
    stochastic rounding whose |u - rho| sits at that noise may go the
    other way, moving the coordinate by one level step instead.  At
    most 0.5% of the coordinates may do so.

One step of ``mixtral-smoke`` (MoE, its aux loss in the loss) and one of
``llama-vision-smoke`` with the pipeline's image embeddings (split over
the workers as the ids are), each with M=2, against the reference's step
run under ``jax.vmap`` over a named data axis, with the same tolerances.
Two steps of ``jamba-smoke`` (Mamba, attention, MoE every other layer)
with bfloat16 parameters and AdamW: the parameters stay bfloat16 and the
moments are float32 after each step, as the reference's state holds them,
and a bfloat16 checkpoint resumes bit-identically.

The launcher's ``--smoke`` on every registered arch.
The same step over the entropy-coded and mixed-width wires and with two
micro-batches (without a level update), and the launcher's ``--codec``,
``--widths`` and ``--micro`` on the CPU.

Then ten M=4 steps of the port alone: the loss falls and the levels move
exactly at the milestones.
"""
from unittest import mock

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P
from test_torch_two_phase import assert_tie_rule

from repro import configs as jconfigs
from repro.core.schemes import QuantScheme as JScheme
from repro.models import Model as JModel
from repro.train.data import DataConfig as JDataConfig
from repro.train.data import Pipeline as JPipeline
from repro.train import train_step as jtrain_step
from repro.train.optim import OptimConfig as JOptimConfig
from repro.train.train_step import TrainConfig as JTrainConfig
from repro.train.train_step import (
    TrainState, compress_state_specs, init_train_state, make_train_step,
    metric_specs)
from repro_torch import configs
from repro_torch.core.codec import codec_for_scheme
from repro_torch.core.schemes import QuantScheme
from repro_torch.models.transformer import Model
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer
from repro_torch.weights import from_jax_params

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

LR = 0.5


def _ravel(tree):
    return np.concatenate([np.asarray(x, np.float32).reshape(-1)
                           for x in jax.tree.leaves(tree)])


def _reference_step(jcfg, scheme_kw, batch_np, **tcfg_kw):
    model = JModel(jcfg, tp=1, dp=1)
    tcfg = JTrainConfig(**{
        **dict(scheme=JScheme(**scheme_kw),
               optim=JOptimConfig(name="sgdm", lr=LR, weight_decay=0.0),
               sync_mode="all_gather", update_milestones=(0,),
               update_every=0, use_pallas=False), **tcfg_kw})
    step_fn = make_train_step(model, tcfg, data_axes=("data",))
    pspecs = model.param_specs()
    # the entropy codec's table is host code: build the algorithm eagerly,
    # not inside the jitted initialisation below
    algo = jtrain_step._make_algo(tcfg)
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))), \
            mock.patch.object(jtrain_step, "_make_algo", lambda _: algo):
        # one compiled program instead of one per operation
        state = jax.jit(lambda k: init_train_state(model, tcfg, k))(
            jax.random.PRNGKey(0))
        sspecs = TrainState(
            params=pspecs, opt=type(state.opt)(mu=pspecs, nu=None,
                                               count=P()),
            scheme_state=jax.tree.map(lambda _: P(), state.scheme_state),
            step=P(), rng=P(),
            compress_state=compress_state_specs(state, ("data",)))
        train = jax.jit(jax.shard_map(
            step_fn,
            in_specs=(sspecs, {"ids": P("data"), "labels": P("data")}),
            out_specs=(sspecs, metric_specs()), check_vma=False))
        new, metrics = train(state, {k: jax.numpy.asarray(v)
                                     for k, v in batch_np.items()})
        return (jax.tree.map(np.asarray, state.params),
                jax.tree.map(np.asarray, new), metrics)


def test_one_step_matches_reference():
    scheme_kw = dict(name="alq", bits=3, bucket_size=1024)
    jcfg = jconfigs.get_config("paper-proxy")
    cfg = configs.get_config("paper-proxy")
    jbatch = JPipeline(JDataConfig(kind="markov", vocab_size=256, seq_len=64,
                                   global_batch=8)).batch(0)
    batch = Pipeline(DataConfig(kind="markov", vocab_size=256, seq_len=64,
                                global_batch=8)).batch(0, "cpu")
    np.testing.assert_array_equal(batch["ids"].numpy(), jbatch["ids"])
    params0, new, jm = _reference_step(jcfg, scheme_kw,
                                       {k: np.asarray(v)
                                        for k, v in jbatch.items()})

    model = Model(cfg, device="cpu")
    model.load_flat(from_jax_params(params0, cfg))
    scheme = QuantScheme(**scheme_kw)
    trainer = Trainer(model, TrainConfig(
        scheme=scheme, optim=OptimConfig(name="sgdm", lr=LR,
                                         weight_decay=0.0),
        update_milestones=(0,), update_every=0, workers=1))
    plan = codec_for_scheme(scheme).plan(model.d)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), 0), 0), 0)
    u = [torch.from_numpy(np.array(jax.random.uniform(
        key, (plan.nb, plan.bucket_size), jax.numpy.float32)))]
    p0 = model.flat.clone()
    m = trainer.train_step(batch, u=u)

    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    assert m["comm_bits_per_coord"] == pytest.approx(
        float(jm["comm_bits_per_coord"]))
    np.testing.assert_allclose(trainer.scheme_state.levels.numpy(),
                               np.asarray(new.scheme_state.levels),
                               atol=1e-4)
    # per coordinate: lr * its bucket's norm, the scale of one level
    g = torch.nn.functional.pad(trainer.grads[0], (0, plan.n - model.d))
    scale = (LR * torch.linalg.vector_norm(g.reshape(plan.nb, -1), dim=1)
             ).repeat_interleave(plan.bucket_size)[:model.d].numpy()
    lv, jlv = (trainer.scheme_state.levels.numpy(),
               np.asarray(new.scheme_state.levels))
    dlev = np.abs(lv - jlv).max()
    want = _ravel(new.params) - p0.numpy()
    diff = np.abs((model.flat - p0).numpy() - want)
    close = diff <= scale * (dlev + 1e-5)
    assert close.mean() >= 0.995, close.mean()
    # a stochastic rounding that went the other way: one level step
    assert np.all(diff <= scale * (np.diff(jlv).max() + dlev + 1e-5))


def _reference_step_vmapped(jcfg, scheme_kw, batch_np, M,
                            optim=JOptimConfig(name="sgdm", lr=LR,
                                               weight_decay=0.0),
                            params=None):
    """The reference's train step for M workers: ``jax.vmap`` over a
    named ``data`` axis (whose collectives the step runs) inside a
    ``model``-axis shard_map, on the rows of each worker (``ids``,
    ``labels`` and any ``vision`` alike).  ``batch_np`` may be a list of
    batches: then one step each, and (initial parameters, a list of (new
    state, metrics), the abstract state a step from the reference's own
    initial state gives).  The steps then start from moments cast to
    float32, the same zeros, so that one program serves every step where
    the initial moments are bfloat16 (they are float32 after a step).
    ``params`` (numpy) replaces the initial weights, which saves
    compiling the reference's initialisation."""
    model = JModel(jcfg, tp=1, dp=1)
    tcfg = JTrainConfig(
        scheme=JScheme(**scheme_kw), optim=optim,
        sync_mode="all_gather", update_milestones=(0,), update_every=0,
        use_pallas=False)
    step_fn = make_train_step(model, tcfg, data_axes=("data",))
    steps = batch_np if isinstance(batch_np, list) else [batch_np]
    out = []
    # each tree operation below is one compiled program, not one an array
    with jax.set_mesh(jax.make_mesh((1,), ("model",))):
        if params is None:
            state = jax.jit(lambda k: init_train_state(model, tcfg, k))(
                jax.random.PRNGKey(0))
        else:
            pdt = jax.numpy.dtype(jcfg.param_dtype)

            def init(k, given):
                given = jax.tree.map(lambda a: a.astype(pdt), given)
                with mock.patch.object(model, "init", lambda _: given):
                    return init_train_state(model, tcfg, k)

            state = jax.jit(init)(jax.random.PRNGKey(0), params)
        params0 = jax.tree.map(np.asarray, state.params)
        train = jax.jit(jax.shard_map(
            jax.vmap(step_fn, in_axes=(None, 0), axis_name="data"),
            in_specs=(P(), P()), out_specs=P(), check_vma=False))
        def split(batch):
            return {k: np.asarray(v).reshape(M, -1, *v.shape[1:])
                    for k, v in batch.items()}

        abstract = jax.eval_shape(train, state, split(steps[0]))[0]
        state = state._replace(opt=jax.jit(lambda opt: jax.tree.map(
            lambda a: a.astype(jax.numpy.float32)
            if jax.numpy.issubdtype(a.dtype, jax.numpy.floating) else a,
            opt))(state.opt))
        # every worker applies the same aggregate: worker 0's state
        first = jax.jit(lambda t: jax.tree.map(lambda a: a[0], t))
        for batch in steps:
            new, metrics = first(train(state, split(batch)))
            state = new
            out.append((jax.tree.map(np.asarray, new),
                        jax.tree.map(np.asarray, metrics)))
    if not isinstance(batch_np, list):
        return (params0, *out[0])
    return params0, out, abstract


def test_one_step_of_mixtral_smoke_with_two_workers_matches_reference():
    """mixtral-smoke (4 experts, top-2, sliding window), M=2, a level
    update at step 0, each worker's uniforms from the reference's keys:
    the tolerances of ``test_one_step_matches_reference``."""
    M = 2
    scheme_kw = dict(name="alq", bits=3, bucket_size=1024)
    jcfg = jconfigs.get_smoke_config("mixtral-8x7b")
    cfg = configs.get_smoke_config("mixtral-8x7b")
    data = dict(kind="markov", vocab_size=cfg.vocab_size, seq_len=32,
                global_batch=4)
    jbatch = JPipeline(JDataConfig(**data)).batch(0)
    params0, new, jm = _reference_step_vmapped(
        jcfg, scheme_kw, {k: np.asarray(v) for k, v in jbatch.items()}, M)

    model = Model(cfg, device="cpu")
    model.load_flat(from_jax_params(params0, cfg))
    scheme = QuantScheme(**scheme_kw)
    trainer = Trainer(model, TrainConfig(
        scheme=scheme, optim=OptimConfig(name="sgdm", lr=LR,
                                         weight_decay=0.0),
        update_milestones=(0,), update_every=0, workers=M))
    plan = codec_for_scheme(scheme).plan(model.d)
    u = []
    for w in range(M):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), 0), w), w)
        u.append(torch.from_numpy(np.array(jax.random.uniform(
            key, (plan.nb, plan.bucket_size), jax.numpy.float32))))
    p0 = model.flat.clone()
    m = trainer.train_step(Pipeline(DataConfig(**data)).batch(0, "cpu"),
                           u=u)

    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    assert m["comm_bits_per_coord"] == pytest.approx(
        float(jm["comm_bits_per_coord"]))
    lv, jlv = (trainer.scheme_state.levels.numpy(),
               np.asarray(new.scheme_state.levels))
    np.testing.assert_allclose(lv, jlv, atol=1e-4)
    # per coordinate: lr * the workers' mean bucket norm bounds one level
    g = torch.nn.functional.pad(trainer.grads, (0, plan.n - model.d))
    norms = torch.linalg.vector_norm(g.reshape(M, plan.nb, -1), dim=2)
    scale = (LR * norms.max(0).values).repeat_interleave(
        plan.bucket_size)[:model.d].numpy()
    dlev = np.abs(lv - jlv).max()
    want = _ravel(new.params) - p0.numpy()
    diff = np.abs((model.flat - p0).numpy() - want)
    close = diff <= scale * (dlev + 1e-5)
    assert close.mean() >= 0.995, close.mean()
    # a stochastic rounding that went the other way: one level step
    assert np.all(diff <= scale * (np.diff(jlv).max() + dlev + 1e-5))


def test_one_step_of_llama_vision_smoke_with_two_workers_matches_reference():
    """llama-vision-smoke (cross-attention on the 5th layer) with the
    pipeline's 16 image embeddings a sequence, M=2, a level update at step
    0, weights from numpy with a non-zero cross gate (the init's 0 would
    shut the block and leave wq, wk, wv and wo without a gradient): the
    tolerances of ``test_one_step_matches_reference``."""
    from test_torch_model import _random_params
    M = 2
    scheme_kw = dict(name="alq", bits=3, bucket_size=1024)
    jcfg = jconfigs.get_smoke_config("llama-3.2-vision-11b")
    cfg = configs.get_smoke_config("llama-3.2-vision-11b")
    data = dict(kind="markov", vocab_size=cfg.vocab_size, seq_len=32,
                global_batch=4)
    jpipe, pipe = JPipeline(JDataConfig(**data)), Pipeline(DataConfig(**data))
    jbatch = dict(jpipe.batch(0), vision=jpipe.vision_stub(
        cfg.num_image_tokens, cfg.d_model, 0))
    batch = dict(pipe.batch(0, "cpu"), vision=pipe.vision_stub(
        cfg.num_image_tokens, cfg.d_model, 0, "cpu"))
    np.testing.assert_array_equal(batch["vision"].numpy(), jbatch["vision"])
    np_params = _random_params(jcfg, seed=2)
    params0, new, jm = _reference_step_vmapped(
        jcfg, scheme_kw, {k: np.asarray(v) for k, v in jbatch.items()}, M,
        params=np_params)

    model = Model(cfg, device="cpu")
    model.load_flat(from_jax_params(params0, cfg))
    scheme = QuantScheme(**scheme_kw)
    trainer = Trainer(model, TrainConfig(
        scheme=scheme, optim=OptimConfig(name="sgdm", lr=LR,
                                         weight_decay=0.0),
        update_milestones=(0,), update_every=0, workers=M))
    plan = codec_for_scheme(scheme).plan(model.d)
    u = []
    for w in range(M):
        key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
            jax.random.PRNGKey(0), 0), w), w)
        u.append(torch.from_numpy(np.array(jax.random.uniform(
            key, (plan.nb, plan.bucket_size), jax.numpy.float32))))
    p0 = model.flat.clone()
    m = trainer.train_step(batch, u=u)
    # the cross block's leaves got a gradient (layer 4 is the cross slot)
    names = [n for n, _ in model.named_parameters()]
    assert "layers.4.cross.wq" in names
    assert model.layers[4].cross["wq"].grad.abs().max() > 0

    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    lv, jlv = (trainer.scheme_state.levels.numpy(),
               np.asarray(new.scheme_state.levels))
    np.testing.assert_allclose(lv, jlv, atol=1e-4)
    g = torch.nn.functional.pad(trainer.grads, (0, plan.n - model.d))
    norms = torch.linalg.vector_norm(g.reshape(M, plan.nb, -1), dim=2)
    scale = (LR * norms.max(0).values).repeat_interleave(
        plan.bucket_size)[:model.d].numpy()
    dlev = np.abs(lv - jlv).max()
    want = _ravel(new.params) - p0.numpy()
    diff = np.abs((model.flat - p0).numpy() - want)
    close = diff <= scale * (dlev + 1e-5)
    assert close.mean() >= 0.995, close.mean()
    assert np.all(diff <= scale * (np.diff(jlv).max() + dlev + 1e-5))


def _bf16(a):
    """float32 numpy -> the bfloat16 values it rounds to, as float32."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(
        torch.bfloat16).float().numpy()


def test_two_bf16_steps_of_jamba_smoke_match_reference():
    """jamba-smoke with ``param_dtype="bfloat16"``, M=2, AdamW, a level
    update at step 0, two steps, weights from numpy (non-zero conv
    weights) rounded to bfloat16 on both sides.  The second step starts
    from the reference's state after the first (its bfloat16 parameters,
    float32 moments and levels, through ``load_state_arrays``): a
    rounding tie that went the other way in the first step moves a
    parameter by a whole AdamW step (lr), and the second step's forward
    then carries it into every gradient.  After each step the parameters
    are bfloat16 and both moments float32 on both sides, and:

      * losses rtol 1e-5 (float32 compute over bfloat16 values);
      * levels atol 1e-4 (ALQ, as above);
      * parameters: AdamW's first step moves a coordinate by lr times
        about sign(Q(g)), and the new value rounds to bfloat16; where
        both packages' float32 values lie on the same side of a rounding
        boundary they give the same bits.  So each parameter within one
        bfloat16 ulp of the reference's, except at a stochastic rounding
        tie (a code that went the other way, at most 0.5% of the
        coordinates);
      * the moments within 1e-3 of their largest entry at 99.5% of the
        coordinates (the same ties)."""
    import dataclasses
    from test_torch_model import _random_params
    M = 2
    scheme_kw = dict(name="alq", bits=3, bucket_size=1024)
    optim_kw = dict(name="adamw", lr=1e-2, weight_decay=1e-2)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(
        "jamba-1.5-large-398b"), param_dtype="bfloat16")
    cfg = dataclasses.replace(configs.get_smoke_config(
        "jamba-1.5-large-398b"), param_dtype="bfloat16")
    data = dict(kind="markov", vocab_size=cfg.vocab_size, seq_len=16,
                global_batch=4)
    jpipe, pipe = JPipeline(JDataConfig(**data)), Pipeline(DataConfig(**data))
    np_params = jax.tree.map(_bf16, _random_params(jcfg, seed=3))
    params0, out, first = _reference_step_vmapped(
        jcfg, scheme_kw, [{k: np.asarray(v) for k, v in jpipe.batch(t).items()}
                          for t in range(2)], M,
        optim=JOptimConfig(**optim_kw), params=np_params)
    assert all(x.dtype == jax.numpy.bfloat16
               for x in jax.tree.leaves(params0))
    # the reference's own first step: bfloat16 moments in, float32 out
    assert all(x.dtype == jax.numpy.bfloat16
               for x in jax.tree.leaves(first.params))
    assert all(x.dtype == np.float32 for x in
               jax.tree.leaves(first.opt.mu) + jax.tree.leaves(first.opt.nu))

    model = Model(cfg, device="cpu")
    assert model.flat.dtype == torch.bfloat16
    model.load_flat(from_jax_params(jax.tree.map(
        lambda a: np.asarray(a, np.float32), params0), cfg))
    scheme = QuantScheme(**scheme_kw)
    trainer = Trainer(model, TrainConfig(
        scheme=scheme, optim=OptimConfig(**optim_kw),
        update_milestones=(0,), update_every=0, workers=M))
    assert trainer.grads.dtype == torch.bfloat16
    plan = codec_for_scheme(scheme).plan(model.d)
    for t, (new, jm) in enumerate(out):
        if t:
            prev = out[t - 1][0]
            arrays = trainer.state_arrays()
            arrays.update({
                "params": torch.from_numpy(_ravel(prev.params)),
                "opt.mu": torch.from_numpy(_ravel(prev.opt.mu)),
                "opt.nu": torch.from_numpy(_ravel(prev.opt.nu)),
                "scheme.levels": torch.from_numpy(np.array(
                    prev.scheme_state.levels))})
            trainer.load_state_arrays(arrays)
            assert model.flat.dtype == torch.bfloat16
        u = []
        for w in range(M):
            key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
                jax.random.PRNGKey(0), t), w), w)
            u.append(torch.from_numpy(np.array(jax.random.uniform(
                key, (plan.nb, plan.bucket_size), jax.numpy.float32))))
        m = trainer.train_step(pipe.batch(t, "cpu"), u=u)
        np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
        np.testing.assert_allclose(trainer.scheme_state.levels.numpy(),
                                   np.asarray(new.scheme_state.levels),
                                   atol=1e-4)
        leaves = jax.tree.leaves(new.params)
        assert all(x.dtype == jax.numpy.bfloat16 for x in leaves)
        assert all(x.dtype == np.float32 for x in
                   jax.tree.leaves(new.opt.mu) + jax.tree.leaves(new.opt.nu))
        assert model.flat.dtype == torch.bfloat16
        assert trainer.opt.mu.dtype == trainer.opt.nu.dtype == torch.float32
        want = _ravel(new.params)
        got = model.flat.float().numpy()
        ulp = np.abs(want) * 2.0 ** -7      # bfloat16: 8 significant bits
        close = np.abs(got - want) <= ulp
        assert close.mean() >= 0.995, (t, close.mean())
        for name, mine, ref in (("mu", trainer.opt.mu, new.opt.mu),
                                ("nu", trainer.opt.nu, new.opt.nu)):
            ref = _ravel(ref)
            near = np.abs(mine.numpy() - ref) <= 1e-3 * np.abs(ref).max()
            assert near.mean() >= 0.995, (t, name, near.mean())


def test_bf16_checkpoint_resumes_bit_identically(tmp_path):
    """jamba-smoke in bfloat16 parameters, M=2, AdamW: 3 steps straight
    against 1 step, a checkpoint, and 2 more from it (the level update at
    step 1 after the resume).  The restored parameters are bfloat16
    again, and the resumed losses and the whole final state equal the
    straight run's bit for bit."""
    import dataclasses
    from repro_torch.train import checkpoint
    cfg = dataclasses.replace(configs.get_smoke_config(
        "jamba-1.5-large-398b"), param_dtype="bfloat16")
    pipe = Pipeline(DataConfig(kind="markov", vocab_size=cfg.vocab_size,
                               seq_len=16, global_batch=4))

    def trainer():
        return Trainer(Model(cfg, device="cpu", seed=1), TrainConfig(
            scheme=QuantScheme(name="alq", bits=3, bucket_size=1024),
            optim=OptimConfig(name="adamw", lr=1e-2, weight_decay=0.0),
            update_milestones=(1,), update_every=0, workers=2), seed=4)

    straight = trainer()
    losses = [straight.train_step(pipe.batch(t, "cpu"))["loss"]
              for t in range(3)]
    first = trainer()
    first.train_step(pipe.batch(0, "cpu"))
    checkpoint.save_step(str(tmp_path), 0, first.state_arrays())
    resumed = trainer()
    _, arrays = checkpoint.restore_latest(str(tmp_path),
                                          resumed.state_arrays())
    assert arrays["params"].dtype == torch.bfloat16
    resumed.load_state_arrays(arrays)
    assert [resumed.train_step(pipe.batch(t, "cpu"))["loss"]
            for t in range(1, 3)] == losses[1:]
    assert resumed.model.flat.dtype == torch.bfloat16
    for k, v in straight.state_arrays().items():
        assert torch.equal(resumed.state_arrays()[k], v), k


def test_one_step_two_phase_ef_integrity_matches_reference():
    """The slice's path, one step: two_phase sync, ef compression and
    integrity words, M=1, no level update (so both packages hold the same
    levels and the only differences are last-ulp norms).  Each parameter
    moves by lr times its aggregate coordinate, held by the two_phase tie
    rule (``test_torch_two_phase.py``); the error-feedback residual
    inp - Q(inp) within 1e-6 of the round trip's scale at 99.9% of the
    coordinates."""
    scheme_kw = dict(name="alq", bits=3, bucket_size=1024)
    jcfg = jconfigs.get_config("paper-proxy")
    cfg = configs.get_config("paper-proxy")
    data = dict(kind="markov", vocab_size=256, seq_len=64, global_batch=8)
    jbatch = JPipeline(JDataConfig(**data)).batch(0)
    params0, new, jm = _reference_step(
        jcfg, scheme_kw, {k: np.asarray(v) for k, v in jbatch.items()},
        sync_mode="two_phase", compress="ef", integrity=True,
        update_milestones=(1,))
    model = Model(cfg, device="cpu")
    model.load_flat(from_jax_params(params0, cfg))
    scheme = QuantScheme(**scheme_kw)
    trainer = Trainer(model, TrainConfig(
        scheme=scheme, optim=OptimConfig(name="sgdm", lr=LR,
                                         weight_decay=0.0),
        sync_mode="two_phase", compress="ef", integrity=True,
        update_milestones=(1,), update_every=0, workers=1))
    plan = codec_for_scheme(scheme).plan(model.d, shards=1)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), 0), 0), 0)
    u = [torch.from_numpy(np.array(jax.random.uniform(
        key, (plan.nb, plan.bucket_size), jax.numpy.float32)))]
    u2 = [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(key, 0x2FA5E), (plan.shard_nb, plan.bucket_size),
        jax.numpy.float32)))]
    p0 = model.flat.clone()
    m = trainer.train_step(Pipeline(DataConfig(**data)).batch(0, "cpu"),
                           u=u, u2=u2)

    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    for k in ("comm_bits_per_coord", "reduce_bits_per_coord",
              "broadcast_bits_per_coord", "kept_fraction"):
        assert m[k] == pytest.approx(float(jm[k]), rel=1e-7), k
    assert m["corrupt_fraction"] == float(jm["corrupt_fraction"]) == 0.0
    assert m["excluded_workers"] == float(jm["excluded_workers"]) == 0.0
    np.testing.assert_allclose(m["residual_norm"], float(jm["residual_norm"]),
                               rtol=1e-5)
    # the aggregate each side applied, lr * g; p0 - lr*g rounds at p0's ulp
    want = (p0.numpy() - _ravel(new.params)) / LR
    got = ((p0 - model.flat) / LR).numpy()
    ulp = 2.0 ** -23 * np.abs(p0.numpy()) / LR
    assert_tie_rule(got, want, plan.bucket_size, slack=2 * ulp)
    res = trainer.compress_state.residual[0].numpy()
    jres = np.asarray(new.compress_state.residual[0])
    g = trainer.grads[0].numpy()       # inp: the gradient plus a zero residual
    close = np.abs(res - jres) <= 1e-6 * np.abs(g - jres).max()
    assert close.mean() >= 0.999, close.mean()


@pytest.mark.parametrize("codec_kw", [
    dict(codec="entropy"), dict(codec="mixed_width",
                                mixed_width_pattern=(2, 4, 3)),
    dict(microbatches=2)])
def test_one_step_of_each_codec_and_micro_matches_reference(codec_kw):
    """One M=1 step without a level update (both packages hold the same
    levels), over the entropy-coded wire, the mixed-width wire, or two
    micro-batches: loss rtol 1e-5; bits/coord (the measured volume, for
    the entropy wire) rtol 1e-6; each parameter moves by lr * Q(g), and a
    coordinate of Q(g) is a level times its bucket's norm, so it is held
    within lr * norm * 1e-5, or one level step off where a rounding tie
    moved (at most 0.5% of the coordinates)."""
    scheme_kw = dict(name="alq", bits=3, bucket_size=1024)
    jcfg = jconfigs.get_config("paper-proxy")
    cfg = configs.get_config("paper-proxy")
    data = dict(kind="markov", vocab_size=256, seq_len=64, global_batch=8)
    jbatch = JPipeline(JDataConfig(**data)).batch(0)
    params0, new, jm = _reference_step(
        jcfg, scheme_kw, {k: np.asarray(v) for k, v in jbatch.items()},
        update_milestones=(1,), **codec_kw)
    model = Model(cfg, device="cpu")
    model.load_flat(from_jax_params(params0, cfg))
    scheme = QuantScheme(**scheme_kw)
    tcfg = TrainConfig(
        scheme=scheme, optim=OptimConfig(name="sgdm", lr=LR,
                                         weight_decay=0.0),
        update_milestones=(1,), update_every=0, workers=1, **codec_kw)
    trainer = Trainer(model, tcfg)
    plan = trainer.algo.codec.plan(model.d)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.fold_in(
        jax.random.PRNGKey(0), 0), 0), 0)
    u = [torch.from_numpy(np.array(jax.random.uniform(
        key, (plan.nb, plan.bucket_size), jax.numpy.float32)))]
    p0 = model.flat.clone()
    m = trainer.train_step(Pipeline(DataConfig(**data)).batch(0, "cpu"), u=u)

    np.testing.assert_allclose(m["loss"], float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["comm_bits_per_coord"],
                               float(jm["comm_bits_per_coord"]), rtol=1e-6)
    g = torch.nn.functional.pad(trainer.grads[0], (0, plan.n - model.d))
    scale = (LR * torch.linalg.vector_norm(g.reshape(plan.nb, -1), dim=1)
             ).repeat_interleave(plan.bucket_size)[:model.d].numpy()
    want = _ravel(new.params) - p0.numpy()
    diff = np.abs((model.flat - p0).numpy() - want)
    close = diff <= scale * 1e-5
    assert close.mean() >= 0.995, close.mean()
    lv = trainer.scheme_state.levels.numpy()
    assert np.all(diff <= scale * (np.diff(lv).max() + 1e-5))


def test_micro_refuses_rows_that_do_not_split():
    cfg = configs.get_config("paper-proxy")
    trainer = Trainer(Model(cfg, device="cpu"), TrainConfig(
        scheme=QuantScheme(bucket_size=1024), workers=2, microbatches=3))
    batch = Pipeline(DataConfig(vocab_size=256, seq_len=16,
                                global_batch=8)).batch(0, "cpu")
    with pytest.raises(ValueError, match="micro-batches"):
        trainer.train_step(batch)


def test_ten_m4_steps_learn_and_adapt_on_schedule():
    cfg = configs.get_config("paper-proxy")
    model = Model(cfg, device="cpu", seed=0)
    trainer = Trainer(model, TrainConfig(
        scheme=QuantScheme(name="alq", bits=3, bucket_size=1024),
        optim=OptimConfig(name="adamw", lr=2e-3, weight_decay=0.0),
        update_milestones=(2, 6), update_every=0, workers=4))
    pipe = Pipeline(DataConfig(kind="markov", vocab_size=cfg.vocab_size,
                               seq_len=64, global_batch=8))
    losses, levels = [], []
    for t in range(10):
        losses.append(trainer.train_step(pipe.batch(t, "cpu"))["loss"])
        levels.append(trainer.scheme_state.levels.clone())
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) - 0.05
    moved = [not torch.equal(a, b) for a, b in zip(levels, levels[1:])]
    # levels after step t; they change at steps 2 and 6 only
    assert moved == [False, True, False, False, False, True, False, False,
                     False]
    assert trainer.scheme_state.num_updates == 2


def test_launcher_trains_on_the_cpu_when_asked(capsys):
    from repro_torch.launch import train
    res = train.run(train.parse_args([
        "--device", "cpu", "--workers", "2", "--steps", "3", "--batch", "4",
        "--seq", "16", "--update-at", "1", "--time-stages"]))
    hist = res["history"]
    assert len(hist) == 3 and res["num_updates"] == 1
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert hist[1]["levels"] != hist[0]["levels"]
    assert hist[2]["levels"] == hist[1]["levels"]
    assert set(hist[0]["stage_ms"]) >= {"grad", "encode", "decode"}
    logged = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("step")]
    assert len(logged) == 2  # step 0 and the last step


@pytest.mark.parametrize("arch", configs.ARCH_NAMES)
def test_launcher_smoke_takes_the_reduced_config(arch):
    """``--smoke``, as in the reference's launcher: the arch's SMOKE
    config, at its width and depth, trains through the quantized wire."""
    from repro_torch.launch import train
    from repro_torch.models.transformer import param_layout
    res = train.run(train.parse_args([
        "--arch", arch, "--smoke", "--device", "cpu", "--workers", "2",
        "--steps", "2", "--batch", "4", "--seq", "16", "--update-at", "1"]))
    cfg = configs.get_smoke_config(arch)
    assert res["config"] == cfg
    assert res["d"] == sum(np.prod(s) for _, s, _ in param_layout(cfg))
    assert res["num_updates"] == 1
    assert all(np.isfinite(h["loss"]) for h in res["history"])




@pytest.mark.parametrize("argv", [
    ["--codec", "entropy"], ["--codec", "entropy:uniform"],
    ["--codec", "mixed_width"],
    ["--codec", "mixed_width", "--widths", "2,4,3"],
    ["--micro", "2"]])
def test_launcher_runs_each_codec_and_micro_on_the_cpu(argv, capsys):
    from repro_torch.core.codec import make_codec
    from repro_torch.launch import train
    res = train.run(train.parse_args([
        "--device", "cpu", "--workers", "2", "--steps", "3", "--batch", "4",
        "--seq", "16", "--update-at", "1", *argv]))
    hist = res["history"]
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    logged = [ln for ln in capsys.readouterr().out.splitlines()
              if ln.startswith("step")]
    assert len(logged) == 2
    args = train.parse_args(argv)
    widths = tuple(int(x) for x in args.widths.split(",") if x)
    codec = make_codec(QuantScheme(bucket_size=1024), args.codec, widths)
    plan = codec.plan(res["d"])
    if plan.variable:   # the entropy wire logs its measured volume
        assert all(" (measured)" in ln for ln in logged)
        assert all(0 < h["comm_bits_per_coord"] <= plan.bits_per_coord
                   for h in hist)
    else:
        assert all(h["comm_bits_per_coord"] == plan.bits_per_coord
                   for h in hist)


@pytest.mark.parametrize("name,nesterov", [("sgdm", False), ("sgdm", True),
                                           ("adamw", False)])
def test_optimizer_matches_reference(name, nesterov):
    """Three steps with warmup and a decay milestone; parameters rtol 1e-6
    (the same float32 formulas; AdamW's bias corrections come from numpy's
    float32 pow, the reference's from XLA's)."""
    from repro.train import optim as jopt
    from repro_torch.train import optim
    kw = dict(name=name, lr=0.05, nesterov=nesterov, weight_decay=1e-2,
              warmup_steps=2, decay_milestones=(2,))
    jcfg, cfg = jopt.OptimConfig(**kw), optim.OptimConfig(**kw)
    rng = np.random.default_rng(0)
    p0 = rng.standard_normal(500).astype(np.float32)
    jp = {"w": jax.numpy.asarray(p0)}
    jstate = jopt.init_opt_state(jcfg, jp)
    flat = torch.from_numpy(p0.copy())
    state = optim.init_opt_state(cfg, flat)
    for _ in range(3):
        g = rng.standard_normal(500).astype(np.float32)
        jp, jstate = jopt.apply_updates(jcfg, jp, {"w": jax.numpy.asarray(g)},
                                        jstate)
        state = optim.apply_updates(cfg, flat, torch.from_numpy(g), state)
    np.testing.assert_allclose(flat.numpy(), np.asarray(jp["w"]), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(state.mu.numpy(), np.asarray(jstate.mu["w"]),
                               rtol=1e-6, atol=1e-7)
    assert state.count == int(jstate.count)


@pytest.mark.parametrize("name", ["sgdm", "adamw"])
@pytest.mark.parametrize("agg", ["float32", "bfloat16"])
def test_bf16_optimizer_matches_reference(name, agg):
    """bfloat16 parameters, two steps with weight decay, from a float32
    aggregate (the quantized wire's) or a bfloat16 one (the plain mean of
    bfloat16 rows): the reference's moments take the aggregate's dtype,
    and the port's, made with ``init_opt_state(..., dtype)``, match them;
    parameters and moments bit-equal, the reference run op by op (each
    side rounds every bfloat16 operation once, and a bfloat16 operand
    meets the Python scalars rounded to bfloat16, as JAX's weak types:
    unrounded, both SGD cases differ)."""
    from repro.train import optim as jopt
    from repro_torch.train import optim
    kw = dict(name=name, lr=0.05, weight_decay=1e-2)
    jcfg, cfg = jopt.OptimConfig(**kw), optim.OptimConfig(**kw)
    jnp, dt = jax.numpy, getattr(torch, agg)
    rng = np.random.default_rng(1)
    p0 = torch.from_numpy(rng.standard_normal(500).astype(np.float32)).to(
        torch.bfloat16)
    jp = {"w": jnp.asarray(p0.float().numpy(), jnp.bfloat16)}
    jstate = jopt.init_opt_state(jcfg, jp)
    flat = p0.clone()
    state = optim.init_opt_state(cfg, flat, dt)
    for _ in range(2):
        g = torch.from_numpy(rng.standard_normal(500).astype(np.float32)
                             ).to(dt)
        with jax.disable_jit():
            jp, jstate = jopt.apply_updates(
                jcfg, jp, {"w": jnp.asarray(g.float().numpy(), agg)}, jstate)
        state = optim.apply_updates(cfg, flat, g, state)
    assert jp["w"].dtype == jnp.bfloat16 and flat.dtype == torch.bfloat16
    moments = [(state.mu, jstate.mu["w"])]
    if name == "adamw":
        moments.append((state.nu, jstate.nu["w"]))
    for got, want in [(flat, jp["w"])] + moments:
        assert str(got.dtype).split(".")[-1] == str(want.dtype)
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize("kind", ["markov", "uniform"])
def test_pipelines_give_the_same_batches(kind):
    jp = JPipeline(JDataConfig(kind=kind, vocab_size=97, seq_len=16,
                               global_batch=4, seed=3))
    tp = Pipeline(DataConfig(kind=kind, vocab_size=97, seq_len=16,
                             global_batch=4, seed=3))
    for step in (0, 5):
        jb, tb = jp.batch(step), tp.batch(step, "cpu")
        for k in ("ids", "labels"):
            np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
