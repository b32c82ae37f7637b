"""Device operations launched a PPM pass (kernels, copies and fills), over
the traced stretch."""


def read(ctx):
    if ctx.trace is None or ctx.mode != "ppm":
        return None
    return len(ctx.trace.device) / ctx.trace.iters
