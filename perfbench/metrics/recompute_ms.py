"""Device milliseconds a step of the model's ``recompute`` spans (a
block's forward replayed by its checkpoint inside a backward: a part of
``backward_ms``), the mean of the clocked steps; None where the program
records no spans."""
from harness import spans


def read(ctx):
    return spans.device_ms(ctx, "recompute")
