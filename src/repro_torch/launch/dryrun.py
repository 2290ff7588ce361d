"""The dry run: does an (architecture x input shape x layout) combination
fit one device of the production layout, and what bounds its step:
compute, memory or wire?  The counterpart of the reference's
``launch/dryrun.py``, without a cluster and without a card.

One rank (rank 0) of the layout runs on the ``meta`` device under torch's
``"fake"`` process-group backend of the layout's world size
(``mesh.fake_grid``): the port's own train step (``Trainer``), prefill or
decode step runs unchanged at full width, its bucket kernels through
their fakes (the route the card runs), its collectives completing at
once.  Nothing is allocated.  ``op_cost`` counts the FLOPs, HBM bytes,
wire bytes and the high-water mark of live bytes of the step;
``roofline`` turns them into an H100's seconds.  A train step is an
update step, as the reference's cost walk takes a ``cond``'s worst
branch: the level update runs, and with it bucket_stats.

Usage (on the CPU; every record is written to ``--out``):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both
  python experiments/make_tables.py experiments/dryrun_torch

The records keep the reference's schema (``ok``, ``microbatches``,
``bytes_per_device``, ``roofline``, ``model_flops_per_device``,
``useful_flops_ratio``, ``error``/``trace``), with ``run_s`` for its
``lower_s``/``compile_s``.  ``bytes_per_device``: ``argument`` the live
bytes when the step starts (parameters, optimizer state, gradient rows,
caches, the batch), ``temp`` the peak above them, ``output`` the bytes
the step returns newly allocated (the train step updates its state in
place), ``total`` argument + temp, the peak.
"""
from __future__ import annotations

import argparse
import functools
import json
import os
import time
import traceback

import torch

from repro_torch import configs
from repro_torch.configs.shapes import SHAPES, input_specs
from repro_torch.core.schemes import QuantScheme
from repro_torch.launch import op_cost, roofline
from repro_torch.launch.mesh import fake_grid, make_production_mesh, mesh_axes
from repro_torch.models.layers import shard_of
from repro_torch.models.transformer import Model
from repro_torch.serve import ServeConfig, make_decode_step, make_prefill_step
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

# archs whose long_500k is skipped (pure full attention)
LONG_SKIP = {
    "qwen1.5-32b", "qwen3-0.6b", "granite-3-2b", "llama3.2-1b",
    "llama-3.2-vision-11b", "musicgen-large",
}

# The reference's budgets are fixed shares of its device's memory, 3/8
# and 1/2; these take the same shares of an NVIDIA H100 80GB's 80 GB.
FSDP_BYTES_THRESHOLD = 30e9  # a device's params(+opt) before FSDP
ACTIVATION_BUDGET = 40e9     # a device's activations before microbatching


def _dp(mesh) -> int:
    dp = 1
    for ax in mesh_axes(mesh)[0]:
        dp *= mesh.shape[ax]
    return dp


def auto_microbatches(cfg, shape, mesh, budget: float = ACTIVATION_BUDGET
                      ) -> int:
    """Smallest power-of-two microbatch count whose per-device activation
    estimate (~3 x layers x B_micro x S x d bf16, the residuals a layer
    keeps plus the backward's transients) fits ``budget``."""
    b_local = max(shape.global_batch // _dp(mesh), 1)
    micro = 1
    while micro < b_local:
        b_micro = b_local // micro
        est = 3.0 * cfg.num_layers * b_micro * shape.seq_len * cfg.d_model * 2
        if est <= budget:
            break
        micro *= 2
    return micro


def plan(cfg, mesh, shape, sync_mode: str = "all_gather",
         fsdp_threshold: float = FSDP_BYTES_THRESHOLD) -> dict:
    """``build_model``'s decisions, the reference's: the cache's sequence
    axes (every axis for a batch-1 long-context decode, whose batch is
    then not split; else the model axis, the batch over the data axes),
    FSDP when a device's parameters (with gradients and momentum when
    training) exceed ``fsdp_threshold``, and the FSDP wire."""
    data_axes, model_axis = mesh_axes(mesh)
    tp = mesh.shape[model_axis]
    if shape.kind == "decode" and shape.global_batch < _dp(mesh):
        seq_axes, batch_axes = tuple(data_axes) + (model_axis,), ()
    else:
        seq_axes, batch_axes = (model_axis,), tuple(data_axes)
    per_dev = cfg.param_count() * (12 if shape.kind == "train" else 4) / tp
    return {
        "tp": tp, "dp": _dp(mesh), "data_axes": tuple(data_axes),
        "seq_axes": seq_axes, "batch_axes": batch_axes,
        "param_mode": "fsdp" if per_dev > fsdp_threshold else "dp",
        "fsdp_sync": ("quantized" if shape.kind == "train"
                      and sync_mode != "fp32" else "fp32"),
    }


def build_model(cfg, mesh, shape, grid, scheme=None,
                sync_mode: str = "all_gather", *, remat: str = "full",
                fsdp_threshold: float = FSDP_BYTES_THRESHOLD):
    """One rank's ``Model`` of ``grid`` (``mesh.fake_grid``'s) on the meta
    device, laid out as ``plan`` decides; returns (model, plan)."""
    p = plan(cfg, mesh, shape, sync_mode, fsdp_threshold)
    seq = tuple("data" if ax == "pod" else ax for ax in p["seq_axes"])
    seq = tuple(dict.fromkeys(seq))      # pod and data: one data group
    model = Model(cfg, device=grid.device, remat=remat,
                  param_mode=p["param_mode"], dp=grid.dp,
                  transport=grid.transport, fsdp_scheme=scheme,
                  fsdp_sync=p["fsdp_sync"], tp_ctx=grid.tp_ctx,
                  data_ctx=grid.data_ctx, seq_shard_axes=seq)
    return model, p


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def dry_pair(cfg, shape, mesh, *, sync_mode: str = "all_gather",
             scheme_name: str = "alq", bits: int = 3, bucket: int = 8192,
             microbatches: int = 1, remat: str = "full"
             ) -> tuple[op_cost.Cost, dict]:
    """Run rank 0's step of (cfg, shape, mesh) on the meta device.

    Returns (its ``op_cost.Cost``, a dict of ``bytes_per_device``, the
    ``plan`` and for a train step ``state_bytes``, the bytes of the
    rank's parameters, optimizer moments and level state): the cost
    counts the step alone, from the live state it starts with; building
    the model, the trainer or the caches is not counted."""
    scheme = QuantScheme(name=scheme_name, bits=bits, bucket_size=bucket)
    specs = input_specs(cfg, shape)
    info = {}
    with fake_grid(mesh) as grid, op_cost.CostMode() as mode:
        model, p = build_model(cfg, mesh, shape, grid, scheme, sync_mode,
                               remat=remat)
        # the rank's rows of the batch: a data rank's share, or all of a
        # batch-1 decode's
        b = (shape.global_batch // p["dp"] if p["batch_axes"]
             else shape.global_batch)
        if shape.kind == "train":
            trainer = Trainer(model, TrainConfig(
                scheme=scheme, optim=OptimConfig(name="sgdm"),
                sync_mode=sync_mode, update_milestones=(0,),
                workers=p["dp"], microbatches=microbatches),
                transport=grid.transport)
            # the trainer takes its worker's rows of the global batch
            batch = dict(specs)
            state = [model.flat, trainer.opt.mu, trainer.opt.nu,
                     *(getattr(trainer.scheme_state, f) for f in
                       ("levels", "multiplier", "entropy_bits"))]
            info["state_bytes"] = op_cost.nbytes(
                [t for t in state if t is not None])
            step = functools.partial(trainer.step_tensors, batch)
        elif shape.kind == "prefill":
            ids = _meta((b, shape.seq_len), torch.int32)
            vision = specs.get("vision")
            vision = None if vision is None else _meta(
                (b,) + tuple(vision.shape[1:]), vision.dtype)
            # the reference's prefill keeps the cache in tp shards
            step = functools.partial(make_prefill_step(
                model, ServeConfig(max_len=shape.seq_len),
                cache_shards=p["tp"]), ids, vision)
        else:
            caches = model.init_cache(
                b, shape.seq_len,
                cache_shards=shard_of(model.seq_ctxs)[0])
            token, pos = _meta((b,), torch.int32), _meta((b,), torch.int32)
            step = functools.partial(make_decode_step(
                model, ServeConfig(max_len=shape.seq_len)), token, pos,
                caches)
        mode.reset()
        argument = mode.live_bytes
        out = step()
        output = mode.new_bytes(out)
        cost = mode.cost
    peak = cost.peak_bytes
    info["bytes_per_device"] = {"argument": argument, "output": output,
                                "temp": peak - argument, "total": peak}
    info["plan"] = p
    return cost, info


def model_flops_per_device(cfg, shape, mesh) -> float:
    """6 N_active D for training, 2 N_active D a prefill, 2 N_active B a
    decode step, over the layout's devices."""
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return mult * cfg.active_param_count() * tokens / mesh.size


def run_one(arch, shape_name, mesh_kind, *, sync_mode, out_dir,
            scheme_name="alq", bits=3, tag="", microbatches=1,
            remat="full"):
    cfg = configs.get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "sync": sync_mode, "scheme": scheme_name, "bits": bits,
        "chips": mesh.size, "tag": tag, "microbatches": microbatches,
        "remat": remat,
    }
    if microbatches == 0 and shape.kind == "train":
        microbatches = auto_microbatches(cfg, shape, mesh)
        rec["microbatches"] = microbatches
    try:
        t0 = time.time()
        cost, info = dry_pair(cfg, shape, mesh, sync_mode=sync_mode,
                              scheme_name=scheme_name, bits=bits,
                              microbatches=microbatches, remat=remat)
        run_s = time.time() - t0
        roof = roofline.from_cost(cost)
        model_flops = model_flops_per_device(cfg, shape, mesh)
        mem = info["bytes_per_device"]
        rec.update({
            "ok": True,
            "run_s": round(run_s, 2),
            "param_mode": info["plan"]["param_mode"],
            "bytes_per_device": mem,
            "roofline": roof.to_dict(),
            "matmul_flops_per_device": cost.matmul_flops,
            "model_flops_per_device": model_flops,
            "useful_flops_ratio": model_flops / max(cost.flops, 1.0),
            "card": roofline.CARD,
        })
        print(f"[OK] {arch} x {shape_name} x {mesh_kind}"
              f" flops/dev={cost.flops:.3e}"
              f" wire={cost.collective_bytes:.3e}B"
              f" dom={roof.dominant}"
              f" useful={rec['useful_flops_ratio']:.2f}"
              f" mem={mem['total'] / 2**30:.1f}GiB"
              f" ({run_s:.1f}s)", flush=True)
    except Exception as e:  # record failures: they are faults to fix
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "trace": traceback.format_exc()[-2000:]})
        print(f"[FAIL] {arch} x {shape_name} x {mesh_kind}: {e}",
              flush=True)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        suffix = f"_{tag}" if tag else ""
        fn = os.path.join(
            out_dir, f"{arch}__{shape_name}__{mesh_kind}{suffix}.json")
        with open(fn, "w") as f:
            json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--sync", default="all_gather",
                    choices=["fp32", "all_gather", "two_phase"])
    ap.add_argument("--scheme", default="alq")
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--tag", default="")
    ap.add_argument("--micro", type=int, default=0,
                    help="microbatches per step; 0 = auto-size")
    ap.add_argument("--remat", default="full",
                    choices=["full", "dots", "psum", "none"])
    args = ap.parse_args(argv)

    archs = configs.ARCH_NAMES if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    t0 = time.time()
    results = []
    for arch in archs:
        for shape_name in shapes:
            if shape_name == "long_500k" and arch in LONG_SKIP:
                print(f"[SKIP] {arch} x long_500k (pure full attention)")
                continue
            for mesh_kind in meshes:
                results.append(run_one(
                    arch, shape_name, mesh_kind, sync_mode=args.sync,
                    out_dir=args.out, scheme_name=args.scheme,
                    bits=args.bits, tag=args.tag,
                    microbatches=args.micro, remat=args.remat))
    n_ok = sum(r["ok"] for r in results)
    print(f"\n{n_ok}/{len(results)} combinations ran in "
          f"{time.time() - t0:.1f} s")
    return 0 if n_ok == len(results) else 1


if __name__ == "__main__":
    raise SystemExit(main())
