"""#5 ``render_wavefront``'s share of its bound (PT): operations
``mega_ops`` of the reference's counts, bytes the pixel indices read and
the image written (20 B a pixel)."""
from benchmark.metrics._roofline import share
from benchmark.workmodel import mega_ops


def read(ctx):
    return share(ctx, "render_wavefront", "pt", lambda c, ctx: (
        ctx.pixels * (8 + 12), mega_ops(c) * c["scale"]))
