"""Millions of eye paths a second: W*H*spp times the iterations completed
in the window, over the window's seconds (PT and BDPT)."""


def read(ctx):
    if ctx.mode not in ("pt", "bdpt"):
        return None
    return ctx.paths_per_iter * ctx.iters / ctx.window_s * 1e-6
