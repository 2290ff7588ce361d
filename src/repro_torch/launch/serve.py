"""Serving launcher: batched prefill and greedy decode of an arch's
reduced (SMOKE) config on one device, random prompts.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3.2-1b \
      --prompt-len 32 --gen 16 --batch 4

Runs on the CUDA device unless ``--device cpu`` is given.  ``--smoke`` is
always on, as in the reference's launcher (a flag kept for its command
lines): it serves the arch's SMOKE config.  ``run`` returns the timings
and the generated tokens so that scripts can drive it too.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch import configs
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
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    cfg = configs.get_smoke_config(args.arch)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device (pass --device cpu to serve on "
                           "the CPU)")
    model = Model(cfg, device=device, seed=SEED)
    scfg = ServeConfig(max_len=args.prompt_len + args.gen)
    prefill = make_prefill_step(model, scfg)
    decode = make_decode_step(model, scfg)
    gen = torch.Generator(device=device).manual_seed(SEED + 1)
    ids = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                        generator=gen, device=device)

    t0 = time.perf_counter()
    tok, caches = prefill(ids)
    _sync(device)
    prefill_ms = (time.perf_counter() - t0) * 1e3
    print(f"prefill({args.batch}x{args.prompt_len}) {prefill_ms:.0f} ms -> "
          f"first tokens {tok.tolist()}", flush=True)
    out = [tok]
    t0 = time.perf_counter()
    for i in range(args.gen - 1):
        pos = torch.full((args.batch,), args.prompt_len + i,
                         dtype=torch.int32, device=device)
        tok, caches = decode(tok, pos, caches)
        out.append(tok)
    _sync(device)
    decode_ms = (time.perf_counter() - t0) * 1e3
    steps = max(args.gen - 1, 1)
    print(f"decoded {args.gen - 1} steps in {decode_ms:.0f} ms "
          f"({decode_ms / steps:.1f} ms/tok)", flush=True)
    tokens = torch.stack(out, dim=1).cpu()
    for b in range(min(args.batch, 2)):
        print(f"  seq[{b}]: {tokens[b].tolist()}", flush=True)
    return {"config": cfg, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "prompt": ids.cpu(), "tokens": tokens}


def main(argv=None) -> None:
    run(parse_args(argv))


if __name__ == "__main__":
    main()
