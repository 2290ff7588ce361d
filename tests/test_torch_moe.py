"""The port's mixture-of-experts FFN (``models/moe.py``) against the
reference's ``moe_ffn``, run at tp = 1 inside a (1, 1) mesh as the
reference's model runs it.

Inputs are made with numpy from a seed at the SMOKE widths (d 256, 4
experts, d_ff 512), T = 2 x 32 tokens, float32: top-2 (mixtral) and
top-1 with the shared expert (llama4), each at capacity factor 1.25 and
0.5 (pairs dropped), and a router of zeros, whose equal probabilities
leave every choice to the tie order.

Tolerances: output and the gradients of x and of every FFN leaf within
1e-5 of their largest entry (float32; sums in another order); aux at
rtol 1e-6 (the reference adds 1/(T k) once per pair, the port divides
the pair counts by T k, which may differ in the last ulp, and the sum
over experts runs in another order).  Expert choices and keep masks are
equal, except that a token's choice may differ where the reference's
gap between its k-th and (k+1)-th probability is under 1e-6.
"""
import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import moe as jmoe
from repro.models.layers import TPCtx
from repro_torch import configs
from repro_torch.models import moe

# one thread: xdist workers that each take every core starve one another
torch.set_num_threads(1)

CASES = {
    "top2": ("mixtral-8x7b", {}),
    "top2_drop": ("mixtral-8x7b", dict(capacity_factor=0.5)),
    "top1_shared": ("llama4-scout-17b-a16e", {}),
    "top1_shared_drop": ("llama4-scout-17b-a16e", dict(capacity_factor=0.5)),
}


def _cfgs(arch, over):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **over),
            dataclasses.replace(configs.get_smoke_config(arch), **over))


def _inputs(cfg, seed, zero_router=False):
    rng = np.random.default_rng(seed)
    d, E, ff = cfg.d_model, cfg.num_experts, cfg.d_ff

    def w(*shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {"router": w(d, E, fan=d), "w1": w(E, d, ff, fan=d),
         "w3": w(E, d, ff, fan=d), "w2": w(E, ff, d, fan=ff)}
    if zero_router:
        p["router"] = np.zeros_like(p["router"])
    if cfg.shared_expert:
        p.update(sw1=w(d, ff, fan=d), sw3=w(d, ff, fan=d),
                 sw2=w(ff, d, fan=ff))
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    dy = rng.standard_normal((2, 32, d)).astype(np.float32)
    return p, x, dy


def _reference(jcfg, p, x, dy):
    """(y, aux, grads of sum(y * dy) + aux w.r.t. (x, p)) from the
    reference's ``moe_ffn``, and its routing: the lines of ``moe_ffn``
    that choose the experts and the kept pairs."""
    ctx = TPCtx(tp=1, dp=1, compute_dtype=jnp.float32)

    def f(p, x, dy):
        def obj(p, x):
            y, aux = jmoe.moe_ffn(ctx, jcfg, p, x)
            return jnp.sum(y * dy) + aux, (y, aux)

        (_, (y, aux)), grads = jax.value_and_grad(
            obj, argnums=(0, 1), has_aux=True)(p, x)
        probs = jax.nn.softmax(
            (x.reshape(-1, x.shape[-1]) @ p["router"]).astype(jnp.float32))
        top, expert = jax.lax.top_k(probs, jcfg.top_k + 1)
        flat_e = expert[:, :jcfg.top_k].reshape(-1)
        onehot = jax.nn.one_hot(flat_e, jcfg.num_experts, dtype=jnp.int32)
        pos = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
        keep = pos < jmoe.capacity(jcfg, x.shape[0] * x.shape[1])
        return y, aux, grads, expert, top, keep

    specs = jax.tree.map(lambda _: P(), (p, x, dy))
    with jax.set_mesh(jax.make_mesh((1, 1), ("data", "model"))):
        fn = jax.jit(jax.shard_map(f, in_specs=specs, out_specs=P(),
                                   check_vma=False))
        out = fn(*jax.tree.map(jnp.asarray, (p, x, dy)))
    return jax.tree.map(np.asarray, out)


def _port(cfg, p, x, dy):
    tp = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    tx = torch.from_numpy(x).requires_grad_()
    y, aux = moe.moe_ffn(cfg, tp, tx)
    (torch.sum(y * torch.from_numpy(dy)) + aux).backward()
    with torch.no_grad():
        xt = tx.reshape(-1, cfg.d_model)
        probs = torch.softmax((xt @ tp["router"]).float(), dim=-1)
        _, expert = moe.route(cfg, probs)
        _, keep, _ = moe.dispatch_positions(
            expert, cfg.num_experts, moe.capacity(cfg, xt.shape[0]))
    grads = {k: v.grad.numpy() for k, v in tp.items()}
    return (y.detach().numpy(), aux.item(), grads, tx.grad.numpy(),
            expert.numpy(), keep.numpy())


def _close(got, want, what):
    err = np.abs(got - want).max()
    assert err <= 1e-5 * np.abs(want).max(), (what, err)


def _check_routing(jcfg, expert, keep, jexpert, jtop, jkeep):
    k = jcfg.top_k
    same = (expert == jexpert[:, :k]).all(axis=1)
    gap = jtop[:, k - 1] - jtop[:, k]
    assert np.all(same | (gap < 1e-6)), np.flatnonzero(~same)
    if same.all():
        np.testing.assert_array_equal(keep, jkeep)


@pytest.mark.parametrize("case", list(CASES))
def test_moe_ffn_matches_reference(case):
    jcfg, cfg = _cfgs(*CASES[case])
    p, x, dy = _inputs(cfg, seed=len(case))
    y, aux, (jgp, jgx), jexpert, jtop, jkeep = _reference(jcfg, p, x, dy)
    ty, taux, gp, gx, expert, keep = _port(cfg, p, x, dy)

    _check_routing(jcfg, expert, keep, jexpert, jtop, jkeep)
    if case.endswith("drop"):
        assert not keep.all() and keep.any()
    else:
        assert keep.all()
    _close(ty, y, "output")
    np.testing.assert_allclose(taux, float(aux), rtol=1e-6)
    _close(gx, jgx, "x gradient")
    assert set(gp) == set(jgp)
    for name in gp:
        _close(gp[name], jgp[name], name)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
def test_equal_probabilities_take_the_lower_expert_first(arch):
    """A router of zeros: every token's probabilities are equal, so the
    top-k is the first k experts (``jax.lax.top_k``'s order), every pair
    lands on them, and those ranked past the capacity drop."""
    jcfg, cfg = _cfgs(arch, {})
    p, x, dy = _inputs(cfg, seed=7, zero_router=True)
    y, aux, (jgp, jgx), jexpert, jtop, jkeep = _reference(jcfg, p, x, dy)
    ty, taux, gp, gx, expert, keep = _port(cfg, p, x, dy)
    T, k = x.shape[0] * x.shape[1], cfg.top_k
    want = np.broadcast_to(np.arange(k), (T, k))
    np.testing.assert_array_equal(expert, want)
    np.testing.assert_array_equal(jexpert[:, :k], want)
    np.testing.assert_array_equal(keep, jkeep)
    C = moe.capacity(cfg, T)
    assert keep.sum() == k * C < T * k
    _close(ty, y, "output")
    np.testing.assert_allclose(taux, float(aux), rtol=1e-6)
    _close(gx, jgx, "x gradient")
    for name in gp:
        _close(gp[name], jgp[name], name)


@pytest.mark.parametrize("arch", ["mixtral-8x7b", "llama4-scout-17b-a16e"])
@pytest.mark.parametrize("factor", [0.5, 1.0, 1.25, 2.0])
def test_capacity_matches_reference(arch, factor):
    for full in (True, False):
        get = "get_config" if full else "get_smoke_config"
        jcfg = dataclasses.replace(getattr(jconfigs, get)(arch),
                                   capacity_factor=factor)
        cfg = dataclasses.replace(getattr(configs, get)(arch),
                                  capacity_factor=factor)
        for T in (1, 7, 32, 64, 100, 1024, 2048, 4096):
            assert moe.capacity(cfg, T) == jmoe.capacity(jcfg, T), T


def test_mixtral_width_capacity():
    """mixtral-8x7b at 2 x 1024 tokens: 8 experts, top-2, capacity 640."""
    assert moe.capacity(configs.get_config("mixtral-8x7b"), 2048) == 640


def test_capacity_follows_each_micro_batch():
    """With k micro-batches a worker's model sees T / k tokens a call, and
    the capacity is that of the micro-batch, as in the reference's
    per-micro-batch loss."""
    from repro_torch.core.schemes import QuantScheme
    from repro_torch.models.transformer import Model
    from repro_torch.train.data import DataConfig, Pipeline
    from repro_torch.train.train_step import TrainConfig, Trainer
    cfg = configs.get_smoke_config("mixtral-8x7b")
    seen = []

    def spy(c, T):
        seen.append(T)
        return capacity(c, T)

    capacity = moe.capacity
    trainer = Trainer(Model(cfg, device="cpu"), TrainConfig(
        scheme=QuantScheme(bucket_size=1024), workers=2, microbatches=2,
        update_milestones=()))
    batch = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                global_batch=8)).batch(0, "cpu")
    with mock.patch.object(moe, "capacity", spy):
        trainer.train_step(batch)
    # 2 workers x 2 micro-batches x 2 MoE layers, each of 2 x 16 tokens,
    # each layer run twice: the default remat ("full") recomputes it in
    # the backward
    assert seen == [2 * 16] * 16
