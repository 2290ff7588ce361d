"""All tokens of all workers over the window's seconds, whole steps only."""


def read(ctx):
    return ctx.steps * ctx.traffic.tokens_per_step / ctx.seconds
