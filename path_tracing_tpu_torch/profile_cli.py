"""Trace one CLI render on the card with ``torch.profiler``:

    python -m path_tracing_tpu_torch.profile_cli --input scenes/cornell.txt \\
        --spp 4 --width 1920 --height 1080 [other cli.py options]

Renders once untraced (warm-up: kernel build and load, allocator), then
once under the profiler, and prints the device time by kernel or op
(``key_averages``, sorted by device time; the integrators' spans there
carry the device time of the kernels under them), the same spans by host
time (each frame's phases and the ``sync.*`` host waits on the card,
``profiling.span``), the render's wall time and the device's busy time
(kernels and copies over the traced call, which also holds the image's
copy to the host), and writes the timeline, spans included, as a Chrome
trace to ``build/profile_cli/trace.json`` (``profiling.maybe_trace``).
Needs a CUDA card; the arguments are ``cli.py``'s, with ``--device cuda``
and an output under the build directory unless given.
"""
from __future__ import annotations

import sys
import time

import torch

from . import cli
from .ops._kernels import BUILD_DIR
from .profiling import TRACE_FILE, maybe_trace

# the names of the integrators' spans begin with these
SPAN_PREFIXES = ("pt.", "bdpt.", "ppm.", "sync.")


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        print("profile_cli: no CUDA device is available", file=sys.stderr)
        return 2
    if "--device" not in argv:
        argv += ["--device", "cuda"]
    if "--output" not in argv:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        argv += ["--output", str(BUILD_DIR / "profile_cli.png")]
    cli.run(argv)
    from torch.autograd import DeviceType

    trace_dir = BUILD_DIR / "profile_cli"
    with maybe_trace(str(trace_dir)) as prof:
        t0 = time.perf_counter()
        res = cli.run(argv)
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    print(events.table(sort_by="self_device_time_total", row_limit=25))
    print("[profile] the integrators' spans, host ms over the traced call:")
    for e in sorted((e for e in events if e.key.startswith(SPAN_PREFIXES)
                     and e.device_type == DeviceType.CPU),
                    key=lambda e: -e.cpu_time_total):
        print(f"  {e.key:<26} {e.count:>6} calls "
              f"{e.cpu_time_total / 1e3:>10.3f} ms")
    # a span's device row is the time of the kernels under it, not work
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA
                  and not e.key.startswith(SPAN_PREFIXES))
    print(f"[profile] {res['tier']} tier: render {res['seconds'] * 1e3:.3f}"
          f" ms wall, device busy {busy_us / 1e3:.3f} ms over the traced "
          f"call of {wall * 1e3:.3f} ms; trace {trace_dir / TRACE_FILE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
