"""Time the three bucket kernels through their entry points
(``kernels.ops.*_op``, the route the train step calls), through the
launch functions (``quantize_cuda`` ...) and, where a checkout has them,
through the kernels' torch operators (``quantize_meta`` ..., which the
entry points call for meta tensors only) on the card, at phase O's FSDP
round shapes (launch-bound) and phase B's shape, as ``chip_smoke.py``
times them: CUDA events around ``reps`` back-to-back calls, a median
and a spread (max - min) over ``rounds`` rounds.

Several checkouts compare in one process: each ``--tree LABEL=SRC``
imports that checkout's ``repro_torch.kernels`` (built from its own
sources) beside the others', and every round times each tree in turn,
so that the host's drift between processes does not enter the
comparison:

    python experiments/kernel_route_times.py \
        --tree parent=<parent checkout>/src --tree change=src

Prints one JSON object: the card's name and power limit, and
milliseconds a call per tree, kernel, path and shape.
"""
import argparse
import importlib
import json
import subprocess
import sys

import torch

BS = 8192
# (buckets, what): a layer slot's FSDP round, embed's or lm_head's round
# (qwen3-0.6b, M = 2), and phase B's whole llama3.2-1b gradient
SHAPES = ((240, "phase O slot round"), (2376, "phase O embed round"),
          (93827, "phase B"))


def timed(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        fn()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / reps


def load_tree(src: str) -> dict:
    """That checkout's kernel modules, imported afresh and built."""
    for name in [m for m in sys.modules if m.split(".")[0] == "repro_torch"]:
        del sys.modules[name]
    sys.path.insert(0, src)
    try:
        mods = {m: importlib.import_module(f"repro_torch.{m}") for m in (
            "core.levels", "kernels.cuda", "kernels.ops",
            "kernels.quantize", "kernels.dequantize",
            "kernels.bucket_stats")}
    finally:
        sys.path.remove(src)
    mods["kernels.cuda"].build()
    return mods


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", action="append", required=True,
                    help="LABEL=SRC, a checkout's src directory")
    ap.add_argument("--rounds", type=int, default=15)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    trees = {}
    for spec in args.tree:
        label, src = spec.split("=", 1)
        trees[label] = load_tree(src)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(13)
    rows = []
    for nb, what in SHAPES:
        vb = torch.randn(nb, BS, generator=g, device=dev) * 1e-3
        u = torch.rand(nb, BS, generator=g, device=dev)
        fns = {}
        for label, m in trees.items():
            ops = m["kernels.ops"]
            q = m["kernels.quantize"].quantize_cuda
            dq = m["kernels.dequantize"].dequantize_cuda
            bs = m["kernels.bucket_stats"].bucket_stats_cuda
            levels = m["core.levels"].uniform_levels(3, device=dev)
            codes, norms = ops.quantize_op(vb, u, levels)
            c32 = codes.to(torch.int32)
            fns.update({
                (label, "quantize", "op"):
                    lambda ops=ops, lv=levels: ops.quantize_op(vb, u, lv),
                (label, "dequantize", "op"):
                    lambda ops=ops, c=c32, n=norms, lv=levels:
                    ops.dequantize_op(c, n, lv),
                (label, "bucket_stats", "op"):
                    lambda ops=ops: ops.bucket_stats_op(vb),
                (label, "quantize", "launch"):
                    lambda q=q, lv=levels: q(vb, u, lv, "l2"),
                (label, "dequantize", "launch"):
                    lambda dq=dq, c=c32, n=norms, lv=levels: dq(c, n, lv),
                (label, "bucket_stats", "launch"):
                    lambda bs=bs: bs(vb, "l2")})
            if hasattr(m["kernels.quantize"], "quantize_meta"):
                # the kernels as torch operators (the meta device's
                # route), launched on the card through the dispatcher
                qm = m["kernels.quantize"].quantize_meta
                dqm = m["kernels.dequantize"].dequantize_meta
                bsm = m["kernels.bucket_stats"].bucket_stats_meta
                fns.update({
                    (label, "quantize", "custom_op"):
                        lambda qm=qm, lv=levels: qm(vb, u, lv, "l2"),
                    (label, "dequantize", "custom_op"):
                        lambda dqm=dqm, c=c32, n=norms, lv=levels:
                        dqm(c, n, lv),
                    (label, "bucket_stats", "custom_op"):
                        lambda bsm=bsm: bsm(vb, "l2")})
        for reps in ((5, 1000) if nb < 10_000 else (5,)):
            ts = {k: [] for k in fns}
            order = list(fns)
            for r in range(args.rounds):
                # each tree first in every other round
                for k in (order if r % 2 == 0 else order[::-1]):
                    ts[k].append(timed(fns[k], reps))
            for (label, k, via), v in ts.items():
                v = sorted(v)
                rows.append(dict(tree=label, kernel=k, via=via,
                                 shape=f"({nb}, {BS})", what=what,
                                 reps=reps, ms=v[len(v) // 2],
                                 spread=v[-1] - v[0]))
        del vb, u, fns
        torch.cuda.empty_cache()
    print(json.dumps(dict(card=smi, trees=args.tree, rows=rows)),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
