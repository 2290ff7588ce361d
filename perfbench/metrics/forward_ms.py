"""Device milliseconds a step of the trainer's ``forward`` spans (each
worker's ``model.loss`` a micro-batch: the embedding, the blocks, the
chunked loss), the mean of the clocked steps; None where the program
records no spans."""
from harness import spans


def read(ctx):
    return spans.device_ms(ctx, "forward")
