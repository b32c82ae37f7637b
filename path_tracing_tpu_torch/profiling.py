"""Profiling and structured telemetry (``path_tracing_tpu.profiling``).

``Telemetry`` times phases on the host clock, synchronising the card
first when it renders there, and writes one JSON row per phase;
``maybe_trace`` records a ``torch.profiler`` trace of a block and writes
it as a Chrome trace (``chrome://tracing``, Perfetto).
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any

TRACE_FILE = "trace.json"


@dataclass
class Telemetry:
    path: str | None = None
    device: Any = None          # a CUDA device: synchronise before timing
    rows: list = field(default_factory=list)

    def emit(self, **row: Any) -> None:
        row.setdefault("t", time.time())
        self.rows.append(row)
        if self.path:
            with open(self.path, "a") as f:
                f.write(json.dumps(row) + "\n")

    def _sync(self) -> None:
        import torch

        if self.device is not None and torch.device(self.device).type == \
                "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, name: str, paths: int = 0, **extra):
        """Time the block's work (the card's included) as one row."""
        self._sync()
        t0 = time.perf_counter()
        yield
        self._sync()
        dt = time.perf_counter() - t0
        row = {"phase": name, "ms": round(dt * 1000, 3), **extra}
        if paths:
            row["mpaths_per_s"] = round(paths / dt / 1e6, 3)
        self.emit(**row)


@contextlib.contextmanager
def maybe_trace(trace_dir: str | None, cuda: bool = True):
    """Record the block with ``torch.profiler`` (CPU, and the card's
    kernels and copies when ``cuda``) and write ``<trace_dir>/trace.json``
    as a Chrome trace; yields the profile (None and no trace without a
    directory)."""
    if not trace_dir:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
