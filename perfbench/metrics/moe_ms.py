"""Device milliseconds a step of the MoE layers' ``moe`` spans (each
layer's FFN a worker and micro-batch, in the forward and in each
checkpoint's replay of it inside the backward), the mean of the clocked
steps; None where the program records no ``moe`` span (no MoE layer, or
a program without the span)."""
from harness import spans


def read(ctx):
    got = spans.recorded()
    if got is None or not any(s.name == "moe" for s in got):
        return None
    return spans.device_ms(ctx, "moe")
