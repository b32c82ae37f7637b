"""The program's ``sync.*`` spans an iteration, over the traced stretch
(PT and BDPT): the points in a frame where the host waits on the card."""
from benchmark.metrics._spans import host_syncs


def read(ctx):
    return host_syncs(ctx, ("pt", "bdpt"))
