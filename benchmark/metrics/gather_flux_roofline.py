"""#11 ``gather_flux``'s share of its bound (PPM): operations
``gather_ops`` of the reference's counts; bytes the gathered hitpoint rows
(88 B), every hitpoint's output (16 B), the sorted events (48 B) and the
cells' windows (72 B), each read or written once."""
from benchmark.metrics._roofline import share
from benchmark.workmodel import gather_ops


def read(ctx):
    return share(ctx, "gather_flux", "ppm", lambda c, ctx: (
        c["gathered"] * c["scale"] * 88 + ctx.pixels * 16
        + c["events"] * 48 + c["cells"] * 72, gather_ops(c) * c["scale"]))
