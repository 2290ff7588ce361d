"""The most memory allocated on the card during the window, GiB."""


def read(ctx):
    return ctx.peak_bytes / 2 ** 30
