"""Shared by ``glue_ms.*`` and ``device_ops.*``: the device's operations in
the traced stretch that are not the program's named kernels."""
from benchmark.trace import kernel_matcher


def glue_seconds(ctx) -> float:
    named = kernel_matcher(ctx.kernel_names)
    return ctx.trace.seconds(lambda n: not named(n))
