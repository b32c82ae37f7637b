"""A profiled stretch of the window, read from ``torch.profiler``'s Chrome
trace: the device's operations, what the host ran, and the stretch's span.

The harness marks the stretch with the host span ``bench.window`` and each
iteration's calls with ``bench.frame``, ``bench.accumulate`` and
``bench.sync``, so that an idle gap of the device is named by the host
work under it."""
from __future__ import annotations

import json
import re
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "python_function",
             "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


@dataclass
class Stretch:
    """The traced iterations: ``t0``/``t1`` (microseconds, the trace's
    clock), the device operations (name, start, end) inside them, the host
    events (name, start, end) and the iterations traced."""

    t0: float
    t1: float
    iters: int
    device: list = field(default_factory=list)
    host: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device operations' intervals, clipped to the
        stretch, in order."""
        out = []
        for _, a, b in sorted(self.device, key=lambda e: e[1]):
            a, b = max(a, self.t0), min(b, self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-6

    def seconds(self, match) -> float:
        """Device seconds of the operations whose name ``match`` accepts."""
        return sum(b - a for n, a, b in self.device if match(n)) * 1e-6

    def top_ops(self, k: int = 10) -> list:
        """The ``k`` device operations by total seconds: [[name, s], ...]."""
        tot: dict = {}
        for n, a, b in self.device:
            name = short_name(n)
            tot[name] = tot.get(name, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda x: -x[1])[:k]]

    def idle_gaps(self, k: int = 10) -> list:
        """The device's idle time in the stretch, summed by the innermost
        host event open at each gap's start: [[host event, s], ...], the
        ``k`` largest."""
        gaps, edge = [], self.t0
        for a, b in self.busy_intervals() + [[self.t1, self.t1]]:
            if a > edge:
                gaps.append((edge, a))
            edge = max(edge, b)
        host = sorted((e for e in self.host if e[0] != WINDOW),
                      key=lambda e: (e[1], -e[2]))
        tot: dict = {}
        stack, j = [], 0
        for a, b in gaps:
            # a sweep over the host events in start order: the stack holds
            # the events open at ``a``, the innermost last
            while j < len(host) and host[j][1] <= a:
                while stack and stack[-1][2] <= host[j][1]:
                    stack.pop()
                stack.append(host[j])
                j += 1
            while stack and stack[-1][2] <= a:
                stack.pop()
            label = stack[-1][0] if stack else "host idle"
            tot[label] = tot.get(label, 0.0) + (b - a) * 1e-6
        return [[n, s] for n, s in
                sorted(tot.items(), key=lambda x: -x[1])[:k]]


def short_name(name: str) -> str:
    """A kernel's name without its return type, template and arguments."""
    name = re.sub(r"^void ", "", name.replace("(anonymous namespace)::", ""))
    return re.split(r"[<(]", name, maxsplit=1)[0].strip() or name


def from_chrome(events: list, iters: int) -> Stretch:
    """The stretch marked ``bench.window`` in a Chrome trace's events."""
    win = [e for e in events if e.get("name") == WINDOW and "dur" in e]
    if not win:
        raise ValueError(f"the trace has no {WINDOW} span")
    t0 = float(win[0]["ts"])
    st = Stretch(t0=t0, t1=t0 + float(win[0]["dur"]), iters=iters)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a = float(e["ts"])
        rec = (e.get("name", "?"), a, a + float(e["dur"]))
        if e.get("cat") in DEVICE_CATS:
            if rec[2] > st.t0 and rec[1] < st.t1:
                st.device.append(rec)
        elif e.get("cat") in HOST_CATS:
            if rec[2] > st.t0 and rec[1] < st.t1:
                st.host.append(rec)
    return st


def load(path, iters: int) -> Stretch:
    with open(path) as f:
        data = json.load(f)
    return from_chrome(data["traceEvents"] if isinstance(data, dict)
                       else data, iters)


def kernel_matcher(names):
    """A predicate: is a device operation one of the program's kernels
    (``<name>_kernel`` for a name in ``names``)?"""
    pat = re.compile(r"\b(" + "|".join(re.escape(n) for n in names)
                     + r")_kernel\b")
    return lambda n: bool(pat.search(n))
