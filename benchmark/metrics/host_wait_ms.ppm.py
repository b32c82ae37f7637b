"""Ms a pass in which the device is idle inside the program's pass spans
(``ppm.pass``), over the traced stretch (PPM)."""
from benchmark.metrics._spans import host_wait_ms


def read(ctx):
    return host_wait_ms(ctx, ("ppm",))
