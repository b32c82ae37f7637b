"""The share of the per-bounce PT loop's lane slots that held a live lane,
in %: ``pt.live_lanes`` over ``pt.lane_slots``, the counters the program
keeps while a profiler runs (``path_tracing_tpu_torch.profiling``, read in
this process; both sum over the same profiled frames).  None where the
program keeps no such counters or ran no per-bounce loop (the
megakernel)."""
import sys


def read(ctx):
    prof = sys.modules.get("path_tracing_tpu_torch.profiling")
    counters = getattr(prof, "counters", None) or {}
    slots = counters.get("pt.lane_slots", 0)
    if ctx.mode != "pt" or not slots:
        return None
    return 100.0 * counters.get("pt.live_lanes", 0) / slots
