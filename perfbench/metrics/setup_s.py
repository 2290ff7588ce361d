"""Seconds from the process's start to the window's: the build (on a
checkout's first run), the model, its first steps."""


def read(ctx):
    return ctx.setup_s
