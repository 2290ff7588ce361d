"""The child processes of the tensor-parallel tests: gloo ranks on the CPU.

Not a test module (pytest collects ``test_*.py`` only).  Each ``spawn_*``
is the body of a process that ``torch.multiprocessing`` spawns through a
``file://`` store under the test's directory; it reads the reference's
results (``reference.npz``, written by ``tests/torch_tp_reference.py``)
and the test's cases (``job.pt``), runs the port's side of each case on
its rank, and saves its results to ``rank<r>.pt``.  ``python
tests/torch_tp_worker.py launch DIR ARGV...`` runs the training launcher
under torchrun and saves each rank's flat and history; ``serve DIR
ARGV...`` the serving launcher, saving each rank's rows and tokens.

Every process runs on one torch thread: the ranks share the host's
cores.  Only ``spawn_fsdp`` imports JAX, to replay the reference's keys
(``test_torch_fsdp_model.JaxKey``).
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs, weights
from repro_torch.core.schemes import QuantScheme
from repro_torch.dist.transport import StackedTransport
from repro_torch.launch import mesh
from repro_torch.models import attention, layers
from repro_torch.models.layers import TPCtx
from repro_torch.models.transformer import Model
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

torch.set_num_threads(1)


def config(case):
    cfg = configs.get_smoke_config(case["arch"])
    return dataclasses.replace(cfg, **case.get("over", {}))


def tree_of(z, prefix: str) -> dict:
    """The reference's tree saved under ``prefix`` (keys joined by '.')
    -> nested dicts (list indices as string keys)."""
    out: dict = {}
    for key in z.files:
        if not key.startswith(prefix + "."):
            continue
        *head, leaf = key[len(prefix) + 1:].split(".")
        node = out
        for h in head:
            node = node.setdefault(h, {})
        node[leaf] = z[key]
    return out


def _join(path: str, world: int, rank: int) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.distributed.init_process_group(
        "gloo", init_method=f"file://{os.path.join(path, 'store')}",
        rank=rank, world_size=world)


def _groups(world: int) -> dict[int, tuple[TPCtx, int]]:
    """tp -> (this rank's context in its model group of tp, the index of
    that group); every rank creates every group in the same order."""
    out = {}
    for tp in (2, 4):
        for first in range(0, world, tp):
            g = dist.new_group(list(range(first, first + tp)))
            if first <= dist.get_rank() < first + tp:
                out[tp] = (TPCtx.over(g, torch.float32), first // tp)
    return out


def model_case(case, ctx: TPCtx, z) -> dict:
    """Loss, gradient flat and parameter flat of this model rank from the
    reference's weights (``from_jax_params``)."""
    cfg, name = config(case), case["name"]
    model = Model(cfg, device="cpu", tp_ctx=ctx)
    init = model.flat.detach().clone()      # the port's own draw, seed 0
    flat = weights.from_jax_params(tree_of(z, f"{name}.w"), cfg, ctx.tp,
                                   ctx.rank)
    model.load_flat(flat)
    row = torch.zeros_like(model.flat)
    model.attach_grads(row)
    b = {k: torch.from_numpy(z[f"{name}.batch.{k}"]) for k in
         ("ids", "labels", "vision") if f"{name}.batch.{k}" in z.files}
    loss = model.loss(b["ids"].long(), b["labels"].long(), b.get("vision"))
    loss.backward()
    return {"loss": loss.detach(), "grad": row, "flat": flat,
            "init": init}


def prim_case(case, ctx: TPCtx, z) -> dict:
    """The primitive's output and the gradients of sum(output * cot) of
    this rank, from the reference's inputs."""
    cfg, name, r = config(case), case["name"], ctx.rank
    args = {k[len(f"{name}.arg."):]: torch.from_numpy(z[k])
            for k in z.files if k.startswith(f"{name}.arg.")}
    mine = {k: (v if k == "x" else v[r]).clone().requires_grad_()
            for k, v in args.items()}
    ids = torch.from_numpy(z[f"{name}.ids"]).long()
    prim = case["prim"]
    if prim == "embed":
        out = layers.embed_lookup(ctx, mine["w"], ids)
    elif prim == "loss":
        out = layers.lm_head_loss(mine["w"], mine["x"], ids[:1], ctx=ctx,
                                  vocab=cfg.vocab_size)
    elif prim == "logits":     # serving's: no gradient
        with torch.no_grad():
            out = layers.lm_head_logits(mine["w"], mine["x"], ctx,
                                        cfg.vocab_size)
        return {"out": out, "grad": {}}
    elif prim == "ffn":
        out = layers.swiglu(mine["x"], mine["w1"], mine["w3"], mine["w2"],
                            ctx)
    else:
        p = {k: v for k, v in mine.items() if k != "x"}
        out = attention.attn_forward(cfg, p, mine["x"], cfg.attn_kind,
                                     ctx=ctx)
    cot = torch.from_numpy(np.asarray(z[f"{name}.cot"]))
    torch.sum(out * cot).backward()
    return {"out": out.detach(),
            "grad": {k: v.grad for k, v in mine.items()}}


def spawn_model(rank: int, world: int, path: str) -> None:
    """The model and primitive cases: a tp = 2 case runs on the pair of
    ranks ``job["pair"][name]``, a tp = 4 case on all four."""
    _join(path, world, rank)
    try:
        job = torch.load(os.path.join(path, "job.pt"))
        groups = _groups(world)
        res = {}
        for kind, z, run in (("model", "model.npz", model_case),
                             ("prims", "prims.npz", prim_case)):
            z = np.load(os.path.join(path, z))
            for case in job[kind]:
                ctx, index = groups[case["tp"]]
                if case["tp"] == 4 or case["pair"] == index:
                    res[case["name"]] = run(case, ctx, z)
        torch.save(res, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def _serve_groups(world: int) -> dict:
    """The groups of the serving cases: a model group of 2 for each pair
    of ranks, one of 4, and the (2, 2) grid's data groups {0, 2} and
    {1, 3} (rank r at data r // 2, model r % 2), each this rank's as a
    float32 ``TPCtx``."""
    out = {tp: ctx for tp, (ctx, _) in _groups(world).items()}
    for m in range(2):
        g = dist.new_group([m, m + 2])
        if dist.get_rank() % 2 == m:
            out["data"] = TPCtx.over(g, torch.float32)
    return out


def _keep(logits, caches) -> dict:
    return {"logits": logits.clone(),
            "caches": [tuple(t.clone() for t in c) for c in caches]}


def serve_case(case, ctx: TPCtx, data_ctx: TPCtx | None, z) -> dict:
    """The port's prefill on this rank from the reference's weights, its
    caches gathered to the global layout, and 3 teacher-forced decode
    steps started from this rank's cut of the reference's prefill caches
    (``from_jax_caches``); with ``split`` the tp = 1 weights cut in tp and
    3 decode steps from the port's own prefill."""
    cfg, name = config(case), case["name"]
    seq = tuple(case.get("seq", ("model",)))
    model = Model(cfg, device="cpu", tp_ctx=ctx, data_ctx=data_ctx,
                  seq_shard_axes=seq)
    model.load_flat(weights.from_jax_params(tree_of(z, f"{name}.w"), cfg,
                                            ctx.tp, ctx.rank))
    ids = torch.from_numpy(z[f"{name}.ids"]).long()
    vision = (torch.from_numpy(z[f"{name}.vision"])
              if f"{name}.vision" in z.files else None)
    S, shards = case["prompt"], case["shards"]
    logits, caches = model.prefill(ids[:, :S], vision,
                                   max_len=case["max_len"],
                                   cache_shards=shards)
    out = {"prefill": _keep(logits, caches),
           "shard": layers.shard_of(model.seq_ctxs)}
    if case.get("split"):
        start = caches
    else:
        out["gathered"] = model.gather_caches(caches)
        out["round_trip"] = all(
            torch.equal(a, b) for x, y in zip(
                model.shard_caches(out["gathered"]), caches)
            for a, b in zip(x, y))
        ref = [(z[f"{name}.c0.{s}.0"], z[f"{name}.c0.{s}.1"])
               for s in range(cfg.group_size)]
        start = weights.from_jax_caches(ref, cfg, ctx.tp, ctx.rank, shards,
                                        out["shard"][1])
    out["steps"] = []
    for i in range(3):
        pos = torch.full((ids.shape[0],), S + i, dtype=torch.int32)
        logits, start = model.decode(ids[:, S + i], pos, start, vision)
        out["steps"].append(_keep(logits, start))
    return out


def spawn_serve(rank: int, world: int, path: str) -> None:
    """The serving cases: a tp = 2 case on the pair of ranks
    ``case["pair"]``, a tp = 4 case and the (2, 2) grid's on all four."""
    _join(path, world, rank)
    try:
        job = torch.load(os.path.join(path, "job.pt"))
        z = np.load(os.path.join(path, "serve.npz"))
        groups = _serve_groups(world)
        res = {}
        for case in job["serve"]:
            tp, dp = case["tp"], case.get("dp", 1)
            if dp > 1 or tp == 4 or case["pair"] == rank // 2:
                res[case["name"]] = serve_case(
                    case, groups[tp], groups["data"] if dp > 1 else None, z)
        torch.save(res, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def train_case(case, z, grid) -> dict:
    """The trainer on one rank of a (dp, tp) grid from the reference's
    weights, with the reference's uniforms: each step's loss, grad norm,
    synced gradient (the momentum of SGD without momentum) and levels."""
    cfg, name = config(case), case["name"]
    ctx, transport = grid.tp_ctx, grid.transport
    w = transport.rank()
    model = Model(cfg, device="cpu", tp_ctx=ctx)
    model.load_flat(weights.from_jax_params(tree_of(z, f"{name}.w"), cfg,
                                            ctx.tp, ctx.rank))
    scheme = QuantScheme(name="alq", bits=3, bucket_size=case["bs"])
    trainer = Trainer(model, TrainConfig(
        scheme=scheme, optim=OptimConfig(name="sgdm", lr=case["lr"],
                                         momentum=0.0, weight_decay=0.0),
        update_milestones=(1,), update_every=0, workers=grid.dp),
        transport=transport)
    out = []
    for t in range(case["steps"]):
        batch = {k: torch.from_numpy(z[f"{name}.{k}"][t]).long()
                 for k in ("ids", "labels")}
        m = trainer.train_step(
            batch, u=[torch.from_numpy(z[f"{name}.u{t}.{w}"])])
        out.append({"metrics": m, "mu": trainer.opt.mu.clone(),
                    "levels": trainer.scheme_state.levels.clone(),
                    "grads": trainer.grads[0].clone()})
    return {"data": w, "model": ctx.rank, "steps": out,
            "state": trainer.state_arrays()}


def spawn_train(rank: int, world: int, path: str) -> None:
    """The trainer cases on a (world // 2, 2) grid."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    grid = mesh.init_grid(
        2, "gloo", "cpu", init_method=f"file://{os.path.join(path, 'store')}")
    try:
        job = torch.load(os.path.join(path, "job.pt"))
        z = np.load(os.path.join(path, "train.npz"))
        res = {c["name"]: train_case(c, z, grid) for c in job["train"]}
        torch.save(res, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_fsdp(rank: int, world: int, path: str) -> None:
    """The FSDP cases: ``world`` model ranks, each holding the M data
    workers stacked, with the reference's keys (``JaxKey``)."""
    import jax
    from test_torch_fsdp_model import JaxKey
    _join(path, world, rank)
    try:
        ctx = TPCtx.over(dist.group.WORLD)
        job = torch.load(os.path.join(path, "job.pt"))
        z = np.load(os.path.join(path, "fsdp.npz"))
        res = {}
        for case in job["fsdp"]:
            cfg, name, M = config(case), case["name"], case["dp"]
            scheme = QuantScheme(name="alq", bits=3,
                                 bucket_size=case["bs"])
            model = Model(cfg, device="cpu", param_mode="fsdp", dp=M,
                          fsdp_scheme=scheme, tp_ctx=ctx)
            model.load_flat(weights.from_jax_fsdp_params(
                tree_of(z, f"{name}.w"), cfg, case["bs"], M, ctx.tp,
                ctx.rank))
            trainer = Trainer(model, TrainConfig(
                scheme=scheme, optim=OptimConfig(
                    name="sgdm", lr=case["lr"], momentum=0.0,
                    weight_decay=0.0),
                update_milestones=(1,), update_every=0, workers=M),
                key=JaxKey(jax.random.PRNGKey(0)))
            steps = []
            for t in range(case["steps"]):
                m = trainer.train_step({
                    k: torch.from_numpy(z[f"{name}.{k}"][t]).long()
                    for k in ("ids", "labels")})
                steps.append({"metrics": m, "levels":
                              trainer.scheme_state.levels.clone(),
                              "mu_all": trainer.opt.mu.clone(),
                              "mu": [model.local_rows(trainer.opt.mu, [w])
                                     for w in range(M)]})
            res[name] = {"steps": steps, "state": trainer.state_arrays()}
        # model ranks that hold unequal numbers of stacked data workers
        model = Model(config(job["fsdp"][0]), device="cpu", tp_ctx=ctx)
        try:
            Trainer(model, TrainConfig(workers=rank + 1),
                    transport=StackedTransport(rank + 1))
        except ValueError as e:
            res["uneven"] = str(e)
        torch.save(res, os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_card(rank: int, world: int, path: str, device: str,
               backend: str) -> None:
    """qwen3-0.6b's SMOKE config at tp = ``world`` on ``device`` (the
    ranks share it), weights drawn on the CPU from seed 0 (a generator on
    the card draws other numbers): this rank's loss and
    gradient, those of ``psum_tp`` on a float32 tensor, and the group's
    all-reduce of it (which ``psum_tp`` skips at tp = 1)."""
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    dev, _ = mesh.init_process_group(
        backend, device, init_method=f"file://{os.path.join(path, 'store')}")
    try:
        ctx = TPCtx.over(dist.group.WORLD, torch.float32)
        cfg = configs.get_smoke_config("qwen3-0.6b")
        model = Model(cfg, device=dev, seed=0, tp_ctx=ctx)
        model.load_flat(Model(cfg, device="cpu", seed=0,
                              tp_ctx=ctx).flat.to(dev))
        row = torch.zeros_like(model.flat)
        model.attach_grads(row)
        g = torch.Generator().manual_seed(1)
        ids = torch.randint(0, cfg.vocab_size, (2, 64), generator=g)
        loss = model.loss(ids.to(dev), ids.roll(1, 1).to(dev))
        loss.backward()
        x = torch.randn(3, 5, generator=g).to(dev).requires_grad_()
        y = ctx.psum_tp(x)
        (y * y).sum().backward()
        raw = layers.tp_all_reduce(x.detach(), ctx.group, "sum")
        torch.save({"loss": loss.detach().cpu(), "grad": row.cpu(),
                    "psum": y.detach().cpu(), "dpsum": x.grad.cpu(),
                    "raw": raw.cpu()},
                   os.path.join(path, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def launch(out_dir: str, argv: list[str]) -> None:
    """The launcher under torchrun; each rank saves its flat and history."""
    from repro_torch.launch import train
    args = train.parse_args(argv)
    try:
        res = train.run(args)
        flat = res["trainer"].model.flat.detach().clone()
        torch.save({"flat": flat, "history": res["history"],
                    "model": res["trainer"].model.ctx.rank},
                   os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_serve(out_dir: str, argv: list[str]) -> None:
    """The serving launcher under torchrun, twice in this process (the
    second run keeps the group the first joined); each rank saves its
    rows and both runs' tokens."""
    from repro_torch.launch import serve
    try:
        res = [serve.run(serve.parse_args(argv)) for _ in range(2)]
        torch.save({"rows": list(res[0]["rows"]), "tokens": res[0]["tokens"],
                    "again": res[1]["tokens"]},
                   os.path.join(out_dir, f"rank{dist.get_rank()}.pt"))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    {"launch": launch, "serve": launch_serve}[sys.argv[1]](sys.argv[2],
                                                          sys.argv[3:])
