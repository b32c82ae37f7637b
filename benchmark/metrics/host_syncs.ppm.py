"""The program's ``sync.*`` spans a pass, over the traced stretch (PPM)."""
from benchmark.metrics._spans import host_syncs


def read(ctx):
    return host_syncs(ctx, ("ppm",))
