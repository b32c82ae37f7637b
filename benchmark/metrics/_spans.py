"""Shared by ``host_wait_ms.*`` and ``host_syncs.*``: the program's own
spans in the traced stretch (``path_tracing_tpu_torch.profiling.span``,
user annotations in the trace).  Each frame's top-level span is
``pt.frame`` or ``bdpt.frame`` (PT, BDPT) or ``ppm.pass`` (PPM); every
point where the host waits on the card is a ``sync.<site>`` span.  A
program without these spans reads None."""

FRAMES = {"pt": ("pt.frame",), "bdpt": ("bdpt.frame",), "ppm": ("ppm.pass",)}
SYNC = "sync."


def frame_intervals(ctx) -> list:
    """The frames' spans clipped to the stretch, in order: [[a, b], ...]
    (microseconds)."""
    names = FRAMES.get(ctx.mode, ())
    st = ctx.trace
    out = []
    for name, a, b in sorted(st.host, key=lambda e: e[1]):
        a, b = max(a, st.t0), min(b, st.t1)
        if name in names and b > a:
            out.append([a, b])
    return out


def idle_in(ctx, spans: list) -> float:
    """Seconds in which no operation ran on the device, within ``spans``
    (disjoint, in order)."""
    busy = ctx.trace.busy_intervals()
    total, j = 0.0, 0
    for a, b in spans:
        covered = 0.0
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        k = j
        while k < len(busy) and busy[k][0] < b:
            covered += min(b, busy[k][1]) - max(a, busy[k][0])
            k += 1
        total += (b - a) - covered
    return total * 1e-6


def host_wait_ms(ctx, modes):
    """Device-idle ms an iteration inside the frames' spans."""
    if ctx.trace is None or ctx.mode not in modes:
        return None
    frames = frame_intervals(ctx)
    if not frames:
        return None
    return idle_in(ctx, frames) / ctx.trace.iters * 1e3


def host_syncs(ctx, modes):
    """``sync.*`` spans that start in the stretch, an iteration."""
    if ctx.trace is None or ctx.mode not in modes or not frame_intervals(ctx):
        return None
    st = ctx.trace
    n = sum(1 for name, a, _ in st.host
            if name.startswith(SYNC) and st.t0 <= a < st.t1)
    return n / st.iters
