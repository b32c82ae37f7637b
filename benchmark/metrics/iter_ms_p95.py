"""The 95th percentile of every iteration's wall time in the window, in
ms: the stall a user of a progressive view sees."""
import math


def p95(values) -> float:
    """The 95th percentile by nearest rank: the smallest sample that at
    least 95% of all samples do not exceed."""
    v = sorted(values)
    return v[max(math.ceil(0.95 * len(v)) - 1, 0)]


def read(ctx):
    return p95(ctx.iter_s) * 1e3
