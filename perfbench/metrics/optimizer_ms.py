"""Device milliseconds of the trainer's ``optimizer`` stage, the mean of
the traced steps."""


def read(ctx):
    return sum(s["optimizer"] for s in ctx.stage_ms) / ctx.steps
