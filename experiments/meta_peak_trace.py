"""Trace the live bytes of one train step operator by operator, on the
card (``torch.cuda.memory_allocated``) and on the meta device (the dry
run's ``op_cost.CostMode``), and print where the two first part and
what each holds at its peak.

The step is ``tests/test_torch_cuda.py``'s meta-peak case by default:
two stacked workers of qwen3-0.6b's SMOKE config, 8 x 1024 tokens, ALQ
3-bit, buckets of 1024, AdamW, the level update.  The card's bytes count
from what it held before the model was built, after a first step.

    PYTHONPATH=src python experiments/meta_peak_trace.py [--arch ...]
        [--device cuda] [--out build/meta_peak_trace.json]

With ``--device cpu`` the host's side records no bytes (a rehearsal of
the operator sequence only).
"""
import argparse
import collections
import json
import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import configs
from repro_torch.core.schemes import QuantScheme
from repro_torch.launch import op_cost
from repro_torch.models.transformer import Model
from repro_torch.train.optim import OptimConfig
from repro_torch.train.train_step import TrainConfig, Trainer


def make_step(cfg, device, mode=None):
    """The step, building its model and trainer; rows of ``mode`` are
    kept from the step's first operator on."""
    def step():
        model = Model(cfg, device=device, seed=0)
        trainer = Trainer(model, TrainConfig(
            scheme=QuantScheme(name="alq", bits=3, bucket_size=1024),
            optim=OptimConfig(name="adamw", lr=1e-4),
            update_milestones=(0,), update_every=0, workers=2), seed=0)
        toks = torch.zeros((8, 1025), dtype=torch.int64, device=device)
        if mode is not None:
            mode.on = True
        trainer.step_tensors({"ids": toks[:, :-1], "labels": toks[:, 1:]})
    return step


class CardTrace(TorchDispatchMode):
    """(operator, bytes allocated less ``base``) after every operator,
    once ``on``."""

    def __init__(self, base: int, on_card: bool):
        super().__init__()
        self.base, self.on_card, self.rows, self.on = base, on_card, [], False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if self.on:
            b = (torch.cuda.memory_allocated() - self.base if self.on_card
                 else 0)
            self.rows.append((str(func), b))
        return out


class MetaTrace(op_cost.CostMode):
    """CostMode that also keeps (operator, live bytes) after every
    operator it sees from outside, once ``on``, and the operator that
    made each live storage."""

    def __init__(self):
        super().__init__()
        self.rows, self.made, self.depth = [], {}, 0
        self.at_peak, self.on = None, False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.depth += 1
        before = set(self._live)
        try:
            out = super().__torch_dispatch__(func, types, args, kwargs)
        finally:
            self.depth -= 1
        for k in set(self._live) - before:
            self.made[k] = (str(func), len(self.rows))
        if self.depth == 0 and self.on:
            self.rows.append((str(func), self.live_bytes))
            if self.at_peak is None or self.live_bytes > self.at_peak[1]:
                self.at_peak = (len(self.rows) - 1, self.live_bytes, [
                    (self.made.get(k, ("before", -1)), v[0])
                    for k, v in self._live.items()])
        return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    cfg = configs.get_smoke_config(args.arch)
    on_card = args.device.startswith("cuda")
    if on_card and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    step = make_step(cfg, args.device)
    base = 0
    if on_card:
        step()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
    card = CardTrace(base, on_card)
    with card:
        make_step(cfg, args.device, card)()
    card_peak = (torch.cuda.max_memory_allocated() - base if on_card
                 else 0)
    meta = MetaTrace()
    with meta:
        make_step(cfg, "meta", meta)()
    c, m = card.rows, meta.rows
    print(f"operators: card {len(c)}, meta {len(m)}; peaks: card "
          f"{card_peak} B (traced max {max(b for _, b in c)}), meta "
          f"{meta.cost.peak_bytes} B")
    same = [i for i in range(min(len(c), len(m))) if c[i][0] != m[i][0]]
    print(f"first operator that differs: {same[0] if same else None}")
    n = min(len(c), len(m))
    first = next((i for i in range(n)
                  if abs(c[i][1] - m[i][1]) > 1 << 20), None)
    print(f"first operator where the bytes differ by > 1 MiB: {first}")
    if first is not None:
        for i in range(max(0, first - 8), min(n, first + 8)):
            print(f"  {i}: card {c[i][0]} {c[i][1]}  meta {m[i][0]} "
                  f"{m[i][1]}")
    ci = max(range(len(c)), key=lambda i: c[i][1])
    mi, mb, held = meta.at_peak
    print(f"card's traced peak at operator {ci} ({c[ci][0]}), meta's at "
          f"{mi} ({m[mi][0]}); there card {c[mi][1] if mi < len(c) else
          None}, meta {mb}")
    for i in range(max(0, mi - 6), min(n, mi + 2)):
        print(f"  {i}: card {c[i][0]} {c[i][1]}  meta {m[i][0]} {m[i][1]}")
    by_op = collections.Counter()
    for (op, _), nbytes in held:
        by_op[op] += nbytes
    print("meta's live bytes at its peak, by the operator that made them:")
    for op, b in by_op.most_common(12):
        print(f"  {b:>12} {op}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"card": c, "meta": m, "card_peak": card_peak,
                       "meta_peak": meta.cost.peak_bytes}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
