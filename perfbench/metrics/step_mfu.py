"""The traced steps' model FLOPs (6 N D) over the traced window's
seconds, as a share of the card's dense bfloat16 peak: the whole step's
share, which bounds what taking any one kernel off the path can gain."""
from harness import shapes


def read(ctx):
    flops = shapes.model_flops(ctx.m, ctx.steps * ctx.traffic.tokens_per_step)
    return 100.0 * flops / ctx.window_s / ctx.peak.bf16_flops
