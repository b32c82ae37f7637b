"""Seconds from the process's start to the first timed iteration: imports,
the card's start, the kernels' load (their build in a fresh checkout),
the scene's parse and pack and one warm-up iteration."""


def read(ctx):
    return ctx.setup_s
