"""The share of the traced stretch in which no operation ran on the
device, in % (PT and BDPT)."""


def read(ctx):
    if ctx.trace is None or ctx.mode not in ("pt", "bdpt"):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
