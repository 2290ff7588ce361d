"""Bits each worker put on the wire a step, per coordinate of its
gradient, as the counting transport saw them."""


def read(ctx):
    return ctx.wire_bits_per_coord
