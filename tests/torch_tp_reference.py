"""The reference side of the tensor-parallel tests, run as a child process
with ``XLA_FLAGS=--xla_force_host_platform_device_count=4``:

    python tests/torch_tp_reference.py MODE OUT.npz CASES_JSON

Not a test module (pytest collects ``test_*.py`` only).  ``MODE``:

* ``model``: for each case, the reference's ``Model(cfg, tp).init`` as
  numpy (Mamba's conv and the cross gate, zero at init, drawn; RWKV6's
  decay path drawn as a trained one has it, the same on every rank), then
  its loss, each rank's gradient and each rank's parameters, both raveled
  inside ``jax.shard_map`` over a (1, tp) mesh, so that they are the flats
  a rank sees; with ``split`` the tp = 1 weights cut into tp shards, and
  the tp = 1 loss and gradient beside them;
* ``prims``: the primitives of ``models/layers.py`` and ``attn_forward``
  over a (1, tp) mesh, with each rank's outputs and input gradients;
* ``train``: the reference's ``make_train_step`` on a (dp, tp) mesh, SGD
  without momentum (the momentum after a step is the synced gradient),
  a level update at step 1; each device's loss, synced gradient flat and
  levels after every step, and the uniforms of every data rank;
* ``fsdp``: the same with ``param_mode="fsdp"`` (jax 0.9.0 removed
  ``batching.BatchTracer``, which ``repro.dist.fsdp._check_not_vmapped``
  reads, so this process replaces that guard with a no-op);
* ``serve``: the reference's ``Model.prefill`` and ``decode`` under
  ``jax.shard_map`` over a (dp, tp) mesh, its caches sequence-sharded
  over ``seq_shard_axes`` in ``cache_shards`` shards and gathered by the
  out-specs of ``cache_pspecs``: the weights, the prefill's logits and
  global caches, and those after each of 3 teacher-forced decode steps
  (one jitted program each for prefill and decode); with ``split`` only
  the tp = 1 weights and the same cut in tp (``split_params``).
"""
import dataclasses
import json
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.flatten_util import ravel_pytree
from jax.sharding import Mesh
from jax.sharding import PartitionSpec as P

from repro import configs
from repro.core.codec import codec_for_scheme
from repro.core.schemes import QuantScheme
from repro.models import Model
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.train.optim import OptimConfig
from repro.train.train_step import (
    TrainConfig, TrainState, init_train_state, make_train_step, metric_specs)


def config(case):
    cfg = configs.get_smoke_config(case["arch"])
    return dataclasses.replace(cfg, **case.get("over", {}))


def mesh_of(dp, tp):
    return Mesh(np.array(jax.devices()[:dp * tp]).reshape(dp, tp),
                ("data", "model"))


def init_params(cfg, tp, dp=1, seed=0, **kw):
    """The reference's own init at tp, with the blocks it leaves shut
    drawn (numpy, per rank) and RWKV6's decay path realistic."""
    model = Model(cfg, tp=tp, dp=dp, **kw)
    tree = jax.tree.map(np.array, jax.jit(model.init)(
        jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed + 1)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        if "conv_w" in name or "conv_b" in name or "'gate'" in name:
            return (0.3 * rng.standard_normal(a.shape)).astype(np.float32)
        if "'w0'" in name:      # replicated: one draw for every rank
            one = rng.uniform(-4, -0.5, a.shape[-1])
            return np.broadcast_to(one, a.shape).astype(np.float32)
        if "w_lora_b" in name:
            one = 0.2 * rng.standard_normal(a.shape[-2:]) / 8.0
            return np.broadcast_to(one, a.shape).astype(np.float32)
        return a

    if kw.get("param_mode") != "fsdp":
        tree = jax.tree_util.tree_map_with_path(draw, tree)
    return model, tree


def batch_of(cfg, seed, B=2, S=32):
    rng = np.random.default_rng(seed)
    out = {"ids": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
               np.int32)}
    if cfg.cross_attn_every:
        out["vision"] = rng.standard_normal(
            (B, 16, cfg.d_model)).astype(np.float32)
    return out


def keep_tree(res, prefix, tree):
    for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
        name = ".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path)
        res[f"{prefix}.{name}"] = np.asarray(leaf, np.float32)


def loss_and_grads(cfg, tp, params, batch):
    """(loss (tp,), gradient flats (tp, d), parameter flats (tp, d)): each
    rank's, raveled inside shard_map."""
    model = Model(cfg, tp=tp, dp=1)
    mesh = mesh_of(1, tp)

    def f(p, b):
        loss, g = jax.value_and_grad(lambda q: model.loss(q, b))(p)
        return (loss[None], ravel_pytree(g)[0][None],
                ravel_pytree(p)[0][None])

    with jax.set_mesh(mesh):
        out = jax.jit(jax.shard_map(
            f, in_specs=(model.param_specs(), P()),
            out_specs=P("model"), check_vma=False))(
            jax.tree.map(jnp.asarray, params),
            {k: jnp.asarray(v) for k, v in batch.items()})
    return [np.asarray(o, np.float32) for o in out]


# leaf -> the axis of one rank's leaf (tp axis squeezed) its shards split
_SPLIT = {"embed": 0, "lm_head": 1, "wq": 1, "bq": 0, "wo": 0, "w1": 1,
          "w3": 1, "w2": 0}


def split_params(tree1, tp):
    """A dense tp = 1 tree -> the same weights as the reference's tp tree:
    each sharded leaf cut in tp along ``_SPLIT``'s axis."""
    def cut(path, a):
        name = path[-1].key
        if name == "final_norm":
            return a
        if name not in _SPLIT:          # replicated: the same on each rank
            return np.repeat(a, tp, axis=0 if name in ("embed", "lm_head")
                             else 1)
        lead = 0 if name in ("embed", "lm_head") else 1
        ax = lead + 1 + _SPLIT[name]
        parts = np.split(a, tp, axis=ax)
        return np.concatenate(parts, axis=lead)
    return jax.tree_util.tree_map_with_path(cut, tree1)


def mode_model(cases):
    res = {}
    for c in cases:
        cfg, tp, name = config(c), c["tp"], c["name"]
        batch = batch_of(cfg, c.get("seed", 0))
        if c.get("split"):
            _, p1 = init_params(cfg, 1)
            params = split_params(p1, tp)
            l1, g1, _ = loss_and_grads(cfg, 1, p1, batch)
            res[f"{name}.tp1_loss"], res[f"{name}.tp1_grad"] = l1, g1
            keep_tree(res, f"{name}.w1", p1)
        else:
            _, params = init_params(cfg, tp)
        keep_tree(res, f"{name}.w", params)
        for k, v in batch.items():
            res[f"{name}.batch.{k}"] = v
        loss, grad, flat = loss_and_grads(cfg, tp, params, batch)
        res[f"{name}.loss"], res[f"{name}.grad"] = loss, grad
        res[f"{name}.flat"] = flat
    return res


def mode_prims(cases):
    """The primitives on random inputs: each rank's output and gradients
    of sum(output * cot) with respect to its float inputs."""
    res = {}
    for c in cases:
        cfg, tp, name = config(c), c["tp"], c["name"]
        dims = jlayers.make_dims(cfg, tp)
        ctx = jlayers.TPCtx(tp=tp, compute_dtype=jnp.float32)
        rng = np.random.default_rng(c.get("seed", 0))
        d, S = cfg.d_model, c.get("S", 32)

        def normal(*shape, scale=1.0):
            return (scale * rng.standard_normal(shape)).astype(np.float32)

        ids = rng.integers(0, cfg.vocab_size, (2, S)).astype(np.int32)
        if c["prim"] == "embed":
            args = {"w": normal(tp, dims.vocab_local, d)}

            def f(a):
                return jlayers.embed_lookup(ctx, a["w"][0], ids)
        elif c["prim"] == "loss":
            args = {"w": normal(tp, d, dims.vocab_local, scale=d ** -0.5),
                    "x": normal(1, S, d)}

            def f(a):
                return jlayers.lm_head_loss(ctx, a["w"][0], a["x"],
                                            ids[:1], cfg.vocab_size)
        elif c["prim"] == "logits":
            args = {"w": normal(tp, d, dims.vocab_local, scale=d ** -0.5),
                    "x": normal(2, d)}

            def f(a):
                return jlayers.lm_head_logits(ctx, a["w"][0], a["x"],
                                              cfg.vocab_size)
        elif c["prim"] == "ffn":
            args = {"w1": normal(tp, d, dims.ff_local, scale=d ** -0.5),
                    "w3": normal(tp, d, dims.ff_local, scale=d ** -0.5),
                    "w2": normal(tp, dims.ff_local, d, scale=d ** -0.5),
                    "x": normal(2, S, d)}

            def f(a):
                p = {k: a[k][0] for k in ("w1", "w2", "w3")}
                return jlayers.ffn_forward(ctx, p, a["x"])
        else:   # attention
            specs = jattn.attn_param_specs(cfg, dims)
            args = {k: normal(tp, *shape, scale=max(code, 1) ** -0.5)
                    for k, (shape, code) in specs.items()}
            for k in ("wk", "wv", "bk", "bv", "q_norm", "k_norm"):
                if k in args:   # replicated: the same on every rank
                    args[k] = np.broadcast_to(args[k][:1], args[k].shape)
            args["x"] = normal(2, S, d)

            def f(a):
                p = {k: v[0] for k, v in a.items() if k != "x"}
                pos = jnp.broadcast_to(jnp.arange(S)[None], (2, S))
                return jattn.attn_forward(ctx, cfg, dims, p, a["x"], pos,
                                          cfg.attn_kind)[0]
        specs_in = {k: (P() if k == "x" else P("model")) for k in args}
        with jax.set_mesh(mesh_of(1, tp)):
            out0 = jax.eval_shape(jax.shard_map(
                f, in_specs=(specs_in,), out_specs=P(), check_vma=False),
                args)
        cot = normal(*out0.shape)

        def g(a):
            def scalar(b):
                return jnp.sum(f(b) * cot)
            out = f(a)
            grads = jax.grad(scalar)(a)
            return out[None], {k: v[None] for k, v in grads.items()}

        with jax.set_mesh(mesh_of(1, tp)):
            out, grads = jax.jit(jax.shard_map(
                g, in_specs=(specs_in,), out_specs=P("model"),
                check_vma=False))(args)
        for k, v in args.items():
            res[f"{name}.arg.{k}"] = v
        res[f"{name}.ids"], res[f"{name}.cot"] = ids, cot
        res[f"{name}.out"] = np.asarray(out)
        for k, v in grads.items():
            res[f"{name}.grad.{k}"] = np.asarray(v)
    return res


def mode_train(cases, fsdp=False):
    res = {}
    for c in cases:
        cfg, tp, dp, name = config(c), c["tp"], c["dp"], c["name"]
        steps, seq, lr = c["steps"], c["seq"], c["lr"]
        scheme = QuantScheme(name="alq", bits=3, bucket_size=c["bs"])
        kw = (dict(param_mode="fsdp", fsdp_scheme=scheme,
                   fsdp_use_pallas=False) if fsdp else {})
        model, params = init_params(cfg, tp, dp, **kw)
        tcfg = TrainConfig(scheme=scheme, optim=OptimConfig(
            name="sgdm", lr=lr, momentum=0.0, weight_decay=0.0),
            update_milestones=(1,), update_every=0, use_pallas=False)
        step_fn = make_train_step(model, tcfg)
        rng = np.random.default_rng(5)
        B = 2 * dp
        ids = rng.integers(0, cfg.vocab_size, (steps, B, seq)).astype(
            np.int32)
        labels = rng.integers(0, cfg.vocab_size, (steps, B, seq)).astype(
            np.int32)
        pspecs = model.param_specs()
        mesh = mesh_of(dp, tp)

        def step(state, batch):
            new, m = step_fn(state, batch)
            dev = (ravel_pytree(new.opt.mu)[0][None, None],
                   new.scheme_state.levels[None, None],
                   m["loss"][None, None], m["grad_norm"][None, None])
            return new, m, dev

        with jax.set_mesh(mesh):
            state = init_train_state(model, tcfg, jax.random.PRNGKey(0))
            state = state._replace(params=jax.tree.map(jnp.asarray, params))
            sspecs = TrainState(
                params=pspecs,
                opt=type(state.opt)(mu=pspecs, nu=None, count=P()),
                scheme_state=jax.tree.map(lambda _: P(), state.scheme_state),
                step=P(), rng=P(), compress_state=None)
            train = jax.jit(jax.shard_map(
                step, in_specs=(sspecs, {"ids": P("data"),
                                         "labels": P("data")}),
                out_specs=(sspecs, metric_specs(), P("data", "model")),
                check_vma=False))
            keep_tree(res, f"{name}.w", params)
            res[f"{name}.ids"], res[f"{name}.labels"] = ids, labels
            for t in range(steps):
                state, _, dev = train(state, {
                    "ids": jnp.asarray(ids[t]),
                    "labels": jnp.asarray(labels[t])})
                for k, v in zip(("mu", "levels", "loss", "grad_norm"), dev):
                    res[f"{name}.{k}{t}"] = np.asarray(v)
        if not fsdp:
            # the uniforms of data rank w at step t: the reference's
            # fold_in(fold_in(fold_in(PRNGKey(0), t), w), w)
            d = res[f"{name}.mu0"].shape[-1]
            plan = codec_for_scheme(scheme).plan(d)
            for t in range(steps):
                for w in range(dp):
                    key = jax.random.fold_in(jax.random.fold_in(
                        jax.random.fold_in(jax.random.PRNGKey(0), t), w), w)
                    res[f"{name}.u{t}.{w}"] = np.asarray(jax.random.uniform(
                        key, (plan.nb, plan.bucket_size), jnp.float32))
    return res


def mode_serve(cases):
    res = {}
    for c in cases:
        cfg, tp, dp, name = config(c), c["tp"], c.get("dp", 1), c["name"]
        seq = tuple(c.get("seq", ("model",)))
        rng = np.random.default_rng(c.get("seed", 0))
        B, S, max_len, shards = c["batch"], c["prompt"], c["max_len"], \
            c["shards"]
        ids = rng.integers(0, cfg.vocab_size, (B, S + 3)).astype(np.int32)
        res[f"{name}.ids"] = ids
        if c.get("split"):
            _, p1 = init_params(cfg, 1)
            keep_tree(res, f"{name}.w1", p1)
            keep_tree(res, f"{name}.w", split_params(p1, tp))
            continue
        model, params = init_params(cfg, tp, dp, data_axes=("data",),
                                    seq_shard_axes=seq)
        keep_tree(res, f"{name}.w", params)
        vision = None
        if cfg.cross_attn_every:
            vision = rng.standard_normal((B, 8, cfg.d_model)).astype(
                np.float32)
            res[f"{name}.vision"] = vision
        pspecs, cspecs = model.param_specs(), model.cache_pspecs(())
        vspec = None if vision is None else P()

        def smap(f, i, o):
            return jax.jit(jax.shard_map(f, in_specs=i, out_specs=o,
                                         check_vma=False))

        def keep(t, logits, caches):
            res[f"{name}.logits{t}"] = np.asarray(logits)
            for slot, pair in enumerate(caches):
                for i, leaf in enumerate(pair):
                    res[f"{name}.c{t}.{slot}.{i}"] = np.asarray(leaf,
                                                               np.float32)

        with jax.set_mesh(mesh_of(dp, tp)):
            pf = smap(lambda p, i, v: model.prefill(
                p, i, v, max_len=max_len, cache_shards=shards),
                (pspecs, P(), vspec), (P(), cspecs))
            df = smap(lambda p, t, pos, cc, v: model.decode(
                p, t, pos, cc, v, cache_shards=shards),
                (pspecs, P(), P(), cspecs, vspec), (P(), cspecs))
            p = jax.tree.map(jnp.asarray, params)
            v = None if vision is None else jnp.asarray(vision)
            logits, caches = pf(p, jnp.asarray(ids[:, :S]), v)
            keep(0, logits, caches)
            for i in range(3):
                logits, caches = df(p, jnp.asarray(ids[:, S + i]),
                                    jnp.full((B,), S + i, jnp.int32),
                                    caches, v)
                keep(i + 1, logits, caches)
    return res


def main():
    mode, out, cases = sys.argv[1], sys.argv[2], json.loads(sys.argv[3])
    if mode == "fsdp":
        import repro.dist.fsdp as fsdp_lib
        fsdp_lib._check_not_vmapped = lambda shard, axes: None
    run = {"model": mode_model, "prims": mode_prims, "train": mode_train,
           "fsdp": lambda c: mode_train(c, fsdp=True),
           "serve": mode_serve}[mode]
    np.savez(out, **run(cases))
    print("REFERENCE_OK")


if __name__ == "__main__":
    main()
