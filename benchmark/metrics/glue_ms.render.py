"""Device ms an iteration in operations other than the program's named
kernels (PyTorch's own kernels, copies and fills: the integrator's host
glue on the device), over the traced stretch (PT and BDPT)."""
from benchmark.metrics._glue import glue_seconds


def read(ctx):
    if ctx.trace is None or ctx.mode not in ("pt", "bdpt"):
        return None
    return glue_seconds(ctx) / ctx.trace.iters * 1e3
