"""Shared by the ``*_roofline`` metrics: a kernel's share of its bound, in
%.  The bound is ``workmodel.bound_s`` of the frozen work model's bytes
and operations of the iteration, counted by the reference on the compared
block and scaled to the frame; the time is the kernel's device seconds an
iteration in the traced stretch.  None where the run has no trace, no
count or no launch of the kernel."""
from benchmark.trace import kernel_matcher
from benchmark.workmodel import bound_s


def share(ctx, kernel: str, mode: str, nbytes_ops):
    if ctx.trace is None or ctx.work is None or ctx.mode != mode:
        return None
    s = ctx.trace.seconds(kernel_matcher([kernel])) / ctx.trace.iters
    if s <= 0:
        return None
    nbytes, ops = nbytes_ops(ctx.work, ctx)
    return 100.0 * bound_s(nbytes, ops) / s
