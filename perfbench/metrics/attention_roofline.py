"""The attention kernels' share of their compute bound in the traced
steps: the least time of their launches (each slot's FLOPs as
``roofline.attention_flops`` counts them at its window, over the card's
dense bfloat16 peak) over the device time of every ``attn_fwd``,
``attn_bwd_dq`` and ``attn_bwd_dkv`` launch.  Under the trainer's remat
"full" each attention layer of each worker launches the forward twice a
step (the forward and its replay inside the backward) and each backward
kernel once; where the trace holds another count of launches their
shapes are not known, and nothing is read.  A configuration whose layer
kinds run no attention kernel reads nothing."""
import collections
import re

from harness import roofline, shapes

NAME = re.compile(r"repro.*?attn_(fwd|bwd_dq|bwd_dkv)(?![a-z_])")
REPLAYS = 2


def read(ctx):
    m, tr = ctx.m, ctx.traffic
    slots = shapes.slots(m)
    attn = [s.mixer.attention_shape(m, j) for j, s in enumerate(slots)
            if hasattr(s.mixer, "attention_shape")]
    if not attn:
        return None
    # each slot's kernels run once a group, worker and (replayed) forward
    per = tr.workers * (m["num_layers"] // len(slots))
    want = {"fwd": REPLAYS * per * len(attn), "bwd_dq": per * len(attn),
            "bwd_dkv": per * len(attn)}
    counts, ns = collections.Counter(), 0
    for name, _, dur, _ in ctx.kernels:
        hit = NAME.search(name)
        if hit:
            counts[hit.group(1)] += 1
            ns += dur
    if counts != {k: ctx.steps * n for k, n in want.items()}:
        return None
    flops = 0
    for heads, hd, window in attn:
        fwd, bwd = roofline.attention_flops(tr.rows_per_worker, tr.seq_len,
                                            heads, hd, window)
        flops += REPLAYS * fwd + bwd
    least = ctx.steps * per * roofline.flops_bound_s(flops, ctx.peak)
    return 100.0 * least / (ns * 1e-9)
