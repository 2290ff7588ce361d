"""Device milliseconds from the end of the ``grad`` stage to the start
of the ``optimizer`` stage, the mean of the traced steps: every stage the
clock recorded but those two, whatever the wire names them."""


def read(ctx):
    return sum(v for s in ctx.stage_ms for k, v in s.items()
               if k not in ("grad", "optimizer")) / ctx.steps
