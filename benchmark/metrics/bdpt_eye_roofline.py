"""#9 ``bdpt_eye``'s share of its bound (BDPT): operations ``eye_ops`` of
the reference's counts, bytes the pixel indices read, the image written
(20 B a pixel) and the tile tables read once (``table_bytes``)."""
from benchmark.metrics._roofline import share
from benchmark.workmodel import eye_ops


def read(ctx):
    return share(ctx, "bdpt_eye", "bdpt", lambda c, ctx: (
        ctx.pixels * (8 + 12) + c.get("table_bytes", 0),
        eye_ops(c) * c["scale"]))
