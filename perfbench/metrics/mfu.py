"""Model FLOPs of the window's steps (6 N D, N the dry run's parameter
count) over its seconds, as a share of the card's dense bfloat16 peak."""
from harness import shapes


def read(ctx):
    flops = shapes.model_flops(ctx.m, ctx.steps * ctx.traffic.tokens_per_step)
    return 100.0 * flops / ctx.seconds / ctx.peak.bf16_flops
