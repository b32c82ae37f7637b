"""Trace one CLI render on the card with ``torch.profiler``:

    python -m path_tracing_tpu_torch.profile_cli --input scenes/cornell.txt \\
        --spp 4 --width 1920 --height 1080 [other cli.py options]

Renders once untraced (warm-up: kernel build and load, allocator), then
once under the profiler, and prints the device time by kernel or op
(``key_averages``, sorted by device time), the render's wall time and the
device's busy time (kernels and copies over the traced call, which also
holds the image's copy to the host), and writes the timeline as a Chrome
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
    busy_us = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA)
    print(f"[profile] {res['tier']} tier: render {res['seconds'] * 1e3:.3f}"
          f" ms wall, device busy {busy_us / 1e3:.3f} ms over the traced "
          f"call of {wall * 1e3:.3f} ms; trace {trace_dir / TRACE_FILE}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
