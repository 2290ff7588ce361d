"""Training launcher: M data-parallel workers, all on one device or one
a process.

  PYTHONPATH=src python -m repro_torch.launch.train --arch paper-proxy \
      --workers 4 --scheme alq --bits 3 --steps 16 --sync all_gather

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 2 -m repro_torch.launch.train --device cpu \
      --backend gloo --arch paper-proxy --steps 16

Runs on the CUDA device unless ``--device cpu`` is given.  ``run``
returns the per-step metrics (and, with ``--time-stages``, the per-stage
milliseconds of each step and, at ``--tp`` > 1, the model group's
all-reduces of each step, ``tp_all_reduce``: calls, bytes and device
milliseconds, from the recorder's spans) so that scripts can drive it
too.  ``--trace-out PATH`` records the steps' spans too
(``repro_torch.timing``) and writes those of the last eight steps to
PATH as Chrome-trace JSON, which opens beside a ``torch.profiler`` trace
in Perfetto.

Started by ``torch.distributed.run`` (``WORLD_SIZE`` in the environment)
it runs one worker a process over a ``ProcessGroupTransport``
(``launch/mesh.py``): ``--backend`` nccl (the default on a card) or gloo
(on the CPU, or several ranks sharing one card), each rank on
``cuda:LOCAL_RANK`` unless ``--device`` names one; ``--workers`` is then
1 or the world size.  Rank 0 logs and saves; every rank checks that its
parameters equal rank 0's after initialisation and after the last step,
and ``run`` returns the same metrics on every rank, equal to a stacked
run's of the same M.

``--tp N`` (under torchrun, ``WORLD_SIZE`` = dp * N) lays the ranks out
as a (data x model) grid (``mesh.init_grid``): each model group of N
ranks runs one tensor-parallel model, and each data group of dp ranks
the quantized wire between the replicas of one model rank.  ``--workers``
is then 1 or dp; rank 0 (data 0, model 0) logs and saves, and the log
lines carry its metrics, as the reference's replicated out-specs give
device 0's.  The replica check runs over each data group.  On the CPU:

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.train --device cpu \
      --arch qwen3-0.6b --smoke --tp 2 --steps 4

``--smoke`` takes the arch's reduced config.  ``--codec
entropy|mixed_width`` (with ``--widths``) picks the wire codec
and ``--micro k`` splits each worker's rows into k micro-batches.

``--ckpt-dir`` saves the trainer's whole state every ``--save-every``
steps and at the last step, and a later launch with the same directory
resumes after the newest checkpoint; ``--save`` writes the final flat
parameters.
"""
from __future__ import annotations

import argparse
import dataclasses
import hashlib
import json
import time

import torch
import torch.distributed as dist

from repro_torch import configs, timing
from repro_torch.core.schemes import QuantScheme
from repro_torch.launch import mesh
from repro_torch.models.layers import tp_all_gather
from repro_torch.models.transformer import Model, to_global
from repro_torch.timing import NO_CLOCK, StageClock
from repro_torch.train.data import DataConfig, Pipeline
from repro_torch.train import checkpoint
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer

LOG_EVERY = 10  # steps between log lines (the last step is logged too)
SEED = 0        # weights, data and the stochastic rounding


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="paper-proxy")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config for this arch")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to this many layers (0 = as "
                         "configured)")
    ap.add_argument("--scheme", default="alq")
    ap.add_argument("--bits", type=int, default=3)
    ap.add_argument("--bucket", type=int, default=1024)
    ap.add_argument("--sync", default="all_gather",
                    choices=["fp32", "all_gather", "two_phase"])
    ap.add_argument("--workers", type=int, default=1,
                    help="M logical data-parallel workers on the device")
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: the ranks of a model "
                         "group under torchrun (WORLD_SIZE = dp * tp)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8,
                    help="global batch (split over the workers)")
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", default="markov", choices=["markov", "uniform"])
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--optim", default="adamw", choices=["sgdm", "adamw"])
    ap.add_argument("--update-at", default="2,10")
    ap.add_argument("--micro", type=int, default=1,
                    help="micro-batches a worker's rows are split into "
                         "(gradient accumulation)")
    ap.add_argument("--codec", default="uniform",
                    choices=["uniform", "mixed_width", "entropy",
                             "entropy:uniform"],
                    help="wire codec: 'entropy' ships the entropy-coded "
                         "payload (gaussian-prior canonical-Huffman table; "
                         "bits/coord in the log is then the measured coded "
                         "volume)")
    ap.add_argument("--widths", default="",
                    help="comma list of per-bucket scheme bits for --codec "
                         "mixed_width (a cyclic pattern; empty = the "
                         "budget-neutral bits-1,bits+1 cycle)")
    ap.add_argument("--compress", default="plain",
                    help="compression algorithm around the codec: plain | "
                         "ef[:warmup] | topk[:k]")
    ap.add_argument("--integrity", action="store_true",
                    help="lay per-bucket checksum words into the wire "
                         "payload; corrupt buckets leave the aggregate")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoint directory: periodic saves of the "
                         "whole training state and auto-resume from the "
                         "newest step_*.npz")
    ap.add_argument("--save-every", type=int, default=0,
                    help="save to --ckpt-dir every N steps (0 = only at "
                         "the end)")
    ap.add_argument("--save", default="",
                    help="write the final flat parameters to this npz")
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda, or cuda:N (under torchrun a bare "
                         "cuda is cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None, choices=mesh.BACKENDS,
                    help="process-group backend under torchrun (default: "
                         "nccl on a card, gloo on the CPU)")
    ap.add_argument("--time-stages", action="store_true",
                    help="time the stages of every step (CUDA events)")
    ap.add_argument("--trace-out", default="",
                    help="record every step's spans and write the last "
                         "eight steps' to this path as Chrome-trace JSON")
    return ap.parse_args(argv)


def resume_state(ckpt_dir: str, trainer: Trainer, log=print) -> int:
    """Auto-resume: load the newest checkpoint in ``ckpt_dir`` into
    ``trainer`` and return the step after it, or 0 for a fresh start."""
    found = checkpoint.restore_latest(ckpt_dir, trainer.state_arrays())
    if found is None:
        return 0
    step, arrays = found
    trainer.load_state_arrays(arrays)
    log(f"resumed step {step} from {checkpoint.step_path(ckpt_dir, step)}")
    return step + 1


def params_digest(flat: torch.Tensor) -> str:
    """sha256 of the flat parameters' bytes."""
    host = flat.detach().contiguous().cpu()
    return hashlib.sha256(host.view(torch.uint8).numpy()).hexdigest()


def check_replicas(transport, flat: torch.Tensor, when: str) -> None:
    """Raise unless every rank's parameters equal rank 0's, bit for bit
    (their digests, gathered)."""
    mine = torch.tensor(list(bytes.fromhex(params_digest(flat))),
                        dtype=torch.uint8, device=flat.device)
    every = transport.all_gather([mine])
    differ = [w for w in range(every.shape[0])
              if not torch.equal(every[w], every[0])]
    if differ:
        raise RuntimeError(f"the parameters of ranks {differ} differ from "
                           f"rank 0's {when}")


def _group(args: argparse.Namespace):
    """(device, transport, workers, TPCtx or None): a process group's
    under torchrun (with ``--tp`` > 1 the data group's transport and the
    model group's context), else the stacked workers' on ``--device``."""
    world = mesh.world_size()
    if not world:
        mesh.refuse_group_flags(args.backend, args.tp)
        return torch.device(args.device), None, args.workers, None
    if args.tp == 1:
        device, transport = mesh.init_process_group(args.backend,
                                                    args.device)
        dp, tp_ctx = world, None
    else:
        grid = mesh.init_grid(args.tp, args.backend, args.device)
        device, transport, tp_ctx, dp = (grid.device, grid.transport,
                                         grid.tp_ctx, grid.dp)
    if args.workers not in (1, dp):
        ranks = "ranks" if tp_ctx is None else "data ranks"
        raise ValueError(f"--workers {args.workers} under {dp} {ranks}: a "
                         f"rank holds one worker, so --workers is 1 or {dp}")
    return device, transport, dp, tp_ctx


def run(args: argparse.Namespace) -> dict:
    cfg = (configs.get_smoke_config(args.arch) if args.smoke
           else configs.get_config(args.arch))
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    device, transport, workers, tp_ctx = _group(args)
    rank0 = transport is None or dist.get_rank() == 0

    def log(msg: str) -> None:
        if rank0:
            print(msg, flush=True)

    model = Model(cfg, device=device, seed=SEED, tp_ctx=tp_ctx)
    if transport is not None:
        check_replicas(transport, model.flat, "after initialisation")
    scheme = QuantScheme(name=args.scheme, bits=args.bits,
                         bucket_size=args.bucket)
    tcfg = TrainConfig(
        scheme=scheme,
        optim=OptimConfig(name=args.optim, lr=args.lr, weight_decay=0.0),
        sync_mode=args.sync,
        update_milestones=tuple(int(x) for x in args.update_at.split(",")
                                if x),
        update_every=0, workers=workers, microbatches=args.micro,
        codec=args.codec,
        mixed_width_pattern=tuple(int(x) for x in args.widths.split(",")
                                  if x),
        compress=args.compress, integrity=args.integrity)
    trainer = Trainer(model, tcfg, seed=SEED, transport=transport)
    start = resume_state(args.ckpt_dir, trainer, log) if args.ckpt_dir else 0
    pipe = Pipeline(DataConfig(kind=args.data, vocab_size=cfg.vocab_size,
                               seq_len=args.seq, global_batch=args.batch,
                               seed=SEED))
    history = []
    record = args.time_stages or bool(args.trace_out)
    timing.reset()
    t0 = time.perf_counter()
    for t in range(start, args.steps):
        batch = pipe.batch(t, device)
        clock = StageClock(device) if record else NO_CLOCK
        t_step = time.perf_counter()
        metrics = trainer.train_step(batch, clock=clock)
        metrics["step_ms"] = (time.perf_counter() - t_step) * 1e3
        metrics["levels"] = trainer.scheme_state.levels.tolist()
        if args.time_stages:
            metrics["stage_ms"] = clock.stage_ms()
            if model.tp > 1:    # the model group's all-reduces of the step
                metrics["tp_all_reduce"] = timing.totals("tp_all_reduce")
        metrics["step"] = t
        history.append(metrics)
        if args.ckpt_dir and ((args.save_every > 0
                               and (t + 1) % args.save_every == 0)
                              or t == args.steps - 1):
            arrays = trainer.state_arrays()     # every rank gathers
            if rank0:
                checkpoint.save_step(args.ckpt_dir, t, arrays)
            del arrays
        if t % LOG_EVERY == 0 or t == args.steps - 1:
            lv = [round(x, 3) for x in metrics["levels"][:4]]
            extra = ("" if args.compress == "plain" else
                     f" |e|={metrics['residual_norm']:.3f}"
                     f" kept={metrics['kept_fraction']:.2f}")
            stages = "".join(f" {k}={v:.1f}ms" for k, v in
                             metrics.get("stage_ms", {}).items())
            # the entropy wire's bits are measured, not planned
            bits = (f"{metrics['comm_bits_per_coord']:.4f} (measured)"
                    if args.codec.startswith("entropy") else
                    f"{metrics['comm_bits_per_coord']:.1f}")
            log(f"step {t:4d} loss={metrics['loss']:.4f} "
                f"|g|={metrics['grad_norm']:.3f} bits/coord={bits}"
                f"{extra} levels={lv}{stages}")
    dt = time.perf_counter() - t0
    ran = args.steps - start
    log(f"done: {ran} steps in {dt:.1f}s "
        f"({dt / max(ran, 1) * 1e3:.0f} ms/step)")
    if args.trace_out and rank0:
        with open(args.trace_out, "w") as f:
            json.dump(timing.chrome_trace(timing.recorded()), f)
        log(f"wrote the spans of the last {timing.KEEP_STEPS} steps to "
            f"{args.trace_out}")
    if transport is not None:
        check_replicas(transport, model.flat, "after the last step")
    if args.save:
        flat = model.flat.detach()
        if model.tp > 1:    # every rank gathers: the reference's layout
            flat = to_global(tp_all_gather(model.ctx, flat), cfg)
        if rank0:
            checkpoint.save(args.save, {"params": flat})
            log(f"saved params to {args.save}")
    return {"config": cfg, "d": model.d, "history": history,
            "num_updates": trainer.scheme_state.num_updates,
            "trainer": trainer}


def main(argv=None) -> None:
    try:
        run(parse_args(argv))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
