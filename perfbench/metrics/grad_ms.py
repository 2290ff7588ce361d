"""Device milliseconds of the trainer's ``grad`` stage (every worker's
forward and backward), the mean of the traced steps."""


def read(ctx):
    return sum(s["grad"] for s in ctx.stage_ms) / ctx.steps
