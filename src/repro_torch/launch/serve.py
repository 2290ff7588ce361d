"""Serving launcher: batched prefill and greedy decode of an arch's
reduced (SMOKE) config, random prompts, on one device or over a
(data x model) grid of processes.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --prompt-len 32 --gen 16 --batch 4

  PYTHONPATH=src python -m torch.distributed.run --standalone \
      --nproc-per-node 4 -m repro_torch.launch.serve --device cpu \
      --backend gloo --tp 2

Runs on the CUDA device unless ``--device cpu`` is given.  ``--smoke`` is
always on, as in the reference's launcher (a flag kept for its command
lines): it serves the arch's SMOKE config.  ``run`` returns the timings
and the generated tokens so that scripts can drive it too.

Started by ``torch.distributed.run`` it joins ``mesh.init_grid(--tp)``
(``WORLD_SIZE`` = dp * tp; a tp that does not divide the world raises),
each rank on ``cuda:LOCAL_RANK`` unless ``--device`` names one, over
``--backend`` (nccl on a card by default; gloo on the CPU or for ranks
sharing one card).  Each model group of tp ranks holds one
tensor-parallel model, its attention caches sequence-sharded over the
group (``cache_shards`` = tp, as the reference's launcher); every rank
draws the same global batch of prompts and serves its data rank's rows
(``--batch`` must be a multiple of dp), and prints their tokens.
"""
from __future__ import annotations

import argparse
import time

import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.launch import mesh
from repro_torch.models.transformer import Model
from repro_torch.serve.engine import (ServeConfig, make_decode_step,
                                      make_prefill_step)

SEED = 0        # the weights; the prompts are drawn from SEED + 1


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--tp", type=int, default=1,
                    help="tensor-parallel degree: the ranks of a model "
                         "group under torchrun (WORLD_SIZE = dp * tp)")
    ap.add_argument("--device", default="cuda",
                    help="cpu, cuda, or cuda:N (under torchrun a bare "
                         "cuda is cuda:LOCAL_RANK)")
    ap.add_argument("--backend", default=None, choices=mesh.BACKENDS,
                    help="process-group backend under torchrun (default: "
                         "nccl on a card, gloo on the CPU)")
    return ap.parse_args(argv)


def prompts(cfg, batch: int, prompt_len: int, device) -> torch.Tensor:
    """The (batch, prompt_len) prompts of every run: the same on every
    rank of a device type."""
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    return torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                         generator=gen, device=device)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    cfg = configs.get_smoke_config(args.arch)
    if mesh.world_size():
        grid = mesh.init_grid(args.tp, args.backend, args.device)
        device, dp, data = grid.device, grid.dp, grid.data_ctx.rank
        if args.batch % dp:
            raise ValueError(f"--batch {args.batch} over {dp} data ranks")
        model = Model(cfg, device=device, seed=SEED, tp_ctx=grid.tp_ctx,
                      data_ctx=grid.data_ctx)
        who = (f"rank {dist.get_rank()} (data {data}, model "
               f"{model.ctx.rank}): ")
    else:
        mesh.refuse_group_flags(args.backend, args.tp)
        device, dp, data, who = torch.device(args.device), 1, 0, ""
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device (pass --device cpu to serve "
                               "on the CPU)")
        model = Model(cfg, device=device, seed=SEED)
    scfg = ServeConfig(max_len=args.prompt_len + args.gen)
    prefill = make_prefill_step(model, scfg, cache_shards=model.tp)
    decode = make_decode_step(model, scfg, cache_shards=model.tp)
    n = args.batch // dp
    rows = range(data * n, (data + 1) * n)
    ids = prompts(cfg, args.batch, args.prompt_len, device)[rows.start:
                                                           rows.stop]

    t0 = time.perf_counter()
    tok, caches = prefill(ids)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    print(f"{who}prefill({n}x{args.prompt_len}) {prefill_ms:.0f} ms -> "
          f"first tokens {tok.tolist()}", flush=True)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        pos = torch.full((n,), args.prompt_len + i, dtype=torch.int32,
                         device=device)
        tok, caches = decode(tok, pos, caches)
        out.append(tok)
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3
    steps = max(args.gen - 1, 1)
    print(f"{who}decoded {args.gen - 1} steps in {decode_ms:.0f} ms "
          f"({decode_ms / steps:.1f} ms/tok)", flush=True)
    tokens = torch.stack(out, dim=1).cpu()
    for b in range(min(n, 2)):
        print(f"{who}  seq[{rows[b]}]: {tokens[b].tolist()}", flush=True)
    return {"config": cfg, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "prompt": ids.cpu(), "tokens": tokens, "rows": rows,
            "model": model}


def main(argv=None) -> None:
    try:
        run(parse_args(argv))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
