"""The reference side of ``test_torch_dryrun.py``, run as a child process:

    python tests/torch_dryrun_reference.py OUT.json CASES_JSON

Not a test module (pytest collects ``test_*.py`` only).  It writes
``{"plans": ..., "costs": ...}``.  ``plans``: for every arch, input shape
and production layout, ``auto_microbatches`` and ``build_model``'s
decisions, read from a stand-in of the mesh (the functions read only its
``shape`` and ``axis_names``), with the reference's budgets.  ``costs``:
for each case
(a SMOKE arch and an input shape) it builds the reference's dry-run
function on a 2 x 2 x 2 ("pod", "data", "model") mesh of 8 host devices
as ``repro.launch.dryrun.lower_pair`` builds it, and walks its jaxpr with
``jaxpr_cost.analyze_fn`` without compiling it (the compile takes
minutes on the CPU).  It writes, per case, the walk's collective wire
bytes (total and by primitive), its dot_general and conv FLOPs (a second
walk with the elementwise and reduction rules off), the model FLOPs a
device as ``run_one`` computes them, and for a train step the bytes a
device holds of the state's parameters, optimizer moments and level
state.

``repro.launch.dryrun`` asks for 512 host devices when it is imported;
the device count is taken first, at 8, so that its request comes too
late.
"""
import json
import math
import os
import sys

os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"

import jax  # noqa: E402

assert len(jax.devices()) == 8

from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

from repro import configs  # noqa: E402
from repro.configs.shapes import SHAPES, InputShape, input_specs  # noqa: E402
from repro.core.schemes import QuantScheme  # noqa: E402
from repro.launch import dryrun, jaxpr_cost  # noqa: E402
from repro.train.optim import OptimConfig  # noqa: E402
from repro.train.train_step import (  # noqa: E402
    TrainConfig, TrainState, init_train_state, make_train_step,
    metric_specs)


def build(cfg, shape, mesh, bits=3, bucket=8192):
    """``lower_pair``'s shard-mapped function and its arguments (its
    lines before ``lower``), and the train state's leaves with their
    specs."""
    scheme = QuantScheme(name="alq", bits=bits, bucket_size=bucket)
    model, batch_axes, data_axes = dryrun.build_model(cfg, mesh, shape,
                                                      scheme, "all_gather")
    model.remat = "full"
    pspecs = model.param_specs()
    pstruct = model.param_struct()
    specs = input_specs(cfg, shape)
    bspec = P(batch_axes) if batch_axes else P()
    state = None
    if shape.kind == "train":
        tcfg = TrainConfig(scheme=scheme, optim=OptimConfig(name="sgdm"),
                           sync_mode="all_gather", microbatches=1,
                           use_pallas=False)
        step = make_train_step(model, tcfg, data_axes=data_axes)
        state_struct = jax.eval_shape(
            lambda: init_train_state(model, tcfg, jax.random.PRNGKey(0)))
        state_specs = TrainState(
            params=pspecs,
            opt=type(state_struct.opt)(
                mu=pspecs,
                nu=None if state_struct.opt.nu is None else pspecs,
                count=P()),
            scheme_state=jax.tree.map(lambda _: P(),
                                      state_struct.scheme_state),
            step=P(), rng=P())
        fn = jax.shard_map(
            step, mesh=mesh, in_specs=(state_specs, {k: bspec for k in specs}),
            out_specs=(state_specs, metric_specs()), check_vma=False)
        args = (state_struct, specs)
        ss = state_struct.scheme_state
        state = [(state_struct.params, pspecs), (state_struct.opt.mu, pspecs),
                 (state_struct.opt.nu, pspecs),
                 ((ss.levels, ss.multiplier, ss.entropy_bits),
                  (P(), P(), P()))]
    elif shape.kind == "prefill":
        cspecs = model.cache_pspecs(batch_axes)

        def prefill(params, batch):
            return model.prefill(params, batch["ids"], batch.get("vision"),
                                 max_len=shape.seq_len,
                                 cache_shards=model.tp)

        fn = jax.shard_map(
            prefill, mesh=mesh, in_specs=(pspecs, {k: bspec for k in specs}),
            out_specs=(bspec, cspecs), check_vma=False)
        args = (pstruct, specs)
    else:
        cache_shards = math.prod(mesh.shape[ax]
                                 for ax in model.seq_shard_axes)
        cspecs = model.cache_pspecs(batch_axes)
        cstruct = model.global_cache_struct(shape.global_batch,
                                            shape.seq_len, cache_shards)

        def decode(params, token, pos, caches):
            logits, new = model.decode(params, token, pos, caches, None,
                                       cache_shards=cache_shards)
            return jax.numpy.argmax(logits, -1).astype("int32"), new

        fn = jax.shard_map(
            decode, mesh=mesh, in_specs=(pspecs, bspec, bspec, cspecs),
            out_specs=(bspec, cspecs), check_vma=False)
        args = (pstruct, specs["token"], specs["pos"], cstruct)
    return fn, args, state


def device_bytes(mesh, tree, specs) -> int:
    """The bytes one device holds of ``tree``'s leaves under ``specs``."""
    leaves = jax.tree.leaves(tree)
    spec_leaves = jax.tree.leaves(specs, is_leaf=lambda x: isinstance(x, P))
    total = 0
    for leaf, spec in zip(leaves, spec_leaves, strict=True):
        shard = NamedSharding(mesh, spec).shard_shape(leaf.shape)
        total += math.prod(shard) * leaf.dtype.itemsize
    return total


class Layout:
    """A production mesh as the dry run's functions read it."""

    def __init__(self, shape: dict):
        self.shape = shape
        self.axis_names = tuple(shape)


LAYOUTS = {"single": Layout({"data": 16, "model": 16}),
           "multi": Layout({"pod": 2, "data": 16, "model": 16})}


def plans() -> list:
    """The decisions as ``build_model`` hands them to ``Model``."""
    built = []

    def model(cfg, **kw):
        built.append(kw)

    real, dryrun.Model = dryrun.Model, model
    out = []
    try:
        for arch in configs.ARCH_NAMES:
            cfg = configs.get_config(arch)
            for shape_name, shape in SHAPES.items():
                for mesh_name, mesh in LAYOUTS.items():
                    _, batch_axes, _ = dryrun.build_model(cfg, mesh, shape)
                    kw = built.pop()
                    out.append({
                        "arch": arch, "shape": shape_name, "mesh": mesh_name,
                        "microbatches": dryrun.auto_microbatches(
                            cfg, shape, mesh),
                        "tp": kw["tp"], "dp": kw["dp"],
                        "data_axes": list(kw["data_axes"]),
                        "seq_axes": list(kw["seq_shard_axes"]),
                        "batch_axes": list(batch_axes),
                        "param_mode": kw["param_mode"],
                        "fsdp_sync": kw["fsdp_sync"]})
    finally:
        dryrun.Model = real
    return out


def main(out_path, cases_json):
    mesh = jax.make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = []
    for case in json.loads(cases_json):
        cfg = configs.get_smoke_config(case["arch"])
        shape = InputShape(*case["shape"])
        fn, args, state = build(cfg, shape, mesh)
        with jax.set_mesh(mesh):
            cost = jaxpr_cost.analyze_fn(fn, *args)
            # the dot_general and conv FLOPs alone
            ew = jaxpr_cost.ELEMENTWISE_FLOP_PRIMS
            red = jaxpr_cost.REDUCE_PRIMS
            jaxpr_cost.ELEMENTWISE_FLOP_PRIMS = jaxpr_cost.REDUCE_PRIMS = set()
            try:
                mm = jaxpr_cost.analyze_fn(fn, *args).flops
            finally:
                jaxpr_cost.ELEMENTWISE_FLOP_PRIMS = ew
                jaxpr_cost.REDUCE_PRIMS = red
        tokens = shape.global_batch * (shape.seq_len
                                       if shape.kind != "decode" else 1)
        mult = 6 if shape.kind == "train" else 2
        rec = {"matmul_flops": mm, "flops": cost.flops,
               "collective_bytes": cost.collective_bytes,
               "by_collective": cost.by_collective,
               "model_flops": mult * cfg.active_param_count() * tokens
               / mesh.size}
        if state is not None:
            rec["state_bytes"] = sum(device_bytes(mesh, t, s)
                                     for t, s in state if t is not None)
        out.append(rec)
    with open(out_path, "w") as f:
        json.dump({"plans": plans(), "costs": out}, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2])
