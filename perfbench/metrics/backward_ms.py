"""Device milliseconds a step of the trainer's ``backward`` spans (each
worker's ``part.backward()`` a micro-batch, the checkpoint's replay of
the blocks included), the mean of the clocked steps; None where the
program records no spans."""
from harness import spans


def read(ctx):
    return spans.device_ms(ctx, "backward")
