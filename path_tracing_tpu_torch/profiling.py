"""Profiling and structured telemetry (``path_tracing_tpu.profiling``).

``Telemetry`` times phases on the host clock, synchronising the card
first when it renders there, and writes one JSON row per phase;
``maybe_trace`` records a ``torch.profiler`` trace of a block and writes
it as a Chrome trace (``chrome://tracing``, Perfetto).

``span`` and ``count`` mark the integrators' frames from inside: each
frame's phases (``pt.frame``, ``bdpt.frame``, ``ppm.pass`` and their
children) and every point where the host waits on the card
(``sync.<site>``) are ``record_function`` spans, so they land in the same
trace as the card's kernels, on the same clock; ``counters`` sums what
``count`` is given.  Both act only while a ``torch.profiler`` runs (the
benchmark's traced runs, ``cli --profile``, ``profile_cli``); otherwise
each costs one read of the profiler's flag.
"""
from __future__ import annotations

import contextlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Any

import torch
import torch.autograd.profiler as _autograd_profiler

TRACE_FILE = "trace.json"
# what ``count`` added while a profiler ran, by name
counters: dict = {}
_OFF = contextlib.nullcontext()


def span(name: str):
    """A context that records the block as ``name`` in the running
    ``torch.profiler``'s trace, or does nothing when none runs."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return torch.profiler.record_function(name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to ``counters[name]`` while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        counters[name] = counters.get(name, 0) + n


def reset_counters() -> None:
    counters.clear()


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
