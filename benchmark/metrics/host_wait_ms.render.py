"""Ms an iteration in which the device is idle inside the program's frame
spans (``pt.frame``, ``bdpt.frame``), over the traced stretch (PT and
BDPT): the host time of the integrators' own work that holds the card
idle.  The rest of ``idle_share.render`` is the harness's (accumulate,
synchronise, loop)."""
from benchmark.metrics._spans import host_wait_ms


def read(ctx):
    return host_wait_ms(ctx, ("pt", "bdpt"))
