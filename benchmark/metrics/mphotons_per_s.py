"""Millions of photons a second: the photons emitted a pass times the
passes completed in the window, over the window's seconds (PPM)."""


def read(ctx):
    if ctx.mode != "ppm":
        return None
    return ctx.photons_per_iter * ctx.iters / ctx.window_s * 1e-6
