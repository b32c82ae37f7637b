"""The share of the traced stretch in which no operation ran on the
device, in % (PPM)."""


def read(ctx):
    if ctx.trace is None or ctx.mode not in ("ppm",):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
