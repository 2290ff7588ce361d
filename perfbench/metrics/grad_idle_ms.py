"""Milliseconds a profiled step in which nothing ran on the card while
the host was inside a ``forward`` or ``backward`` span; None where the
program records no spans."""
from harness import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.GRAD)
