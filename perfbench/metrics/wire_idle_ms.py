"""Milliseconds a profiled step in which nothing ran on the card while
the host was inside one of the wire's spans (``stats`` and ``fit`` on
update steps, ``encode``, ``collective``, ``decode`` with its unpacks
and checksums, ``requant``, ``compress``); None where the program
records no spans."""
from harness import spans


def read(ctx):
    return spans.idle_ms(ctx, spans.WIRE)
