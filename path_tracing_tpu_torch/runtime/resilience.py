"""Failure detection and recovery for long progressive renders
(``path_tracing_tpu.runtime.resilience``).

- :func:`probe_device` runs a trivial op on the card and reads the answer
  back to the host on a watchdog thread: a healthy card answers in
  milliseconds, a hung one turns into ``False`` after ``timeout_s``.
- :class:`RenderSupervisor` drives a per-iteration render callable with
  bounded retries.  On an exception it saves the accumulation through the
  caller's checkpoint hook, synchronises the card and empties PyTorch's
  allocator cache, and re-runs the same iteration on the same device.  It
  never moves the render to the CPU or to the plain versions.  Failures
  are counted per iteration, so one flaky pass cannot spend the whole
  budget.

The CLI wires the supervisor behind ``--retries``.
"""
from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any, Callable


def probe_device(timeout_s: float = 30.0, device="cuda") -> bool:
    """True iff ``device`` completes a trivial op and a host read within
    ``timeout_s``.  Never raises: a hang, an exception and a wrong answer
    all report unhealthy."""
    result: list[bool] = []

    def work():
        try:
            import torch

            x = torch.full((), 20.5, device=device) * 2.0 + 1.0
            result.append(abs(float(x.item()) - 42.0) < 1e-6)
        except Exception:  # noqa: BLE001 — any fault is "unhealthy"
            result.append(False)

    t = threading.Thread(target=work, daemon=True)
    t.start()
    t.join(timeout_s)
    return bool(result) and result[0]


class StopRender(BaseException):
    """Graceful early stop requested from inside ``on_frame`` (the CLI's
    SIGUSR2).  A BaseException, so the supervisor's retry loop (``except
    Exception``) lets it through instead of re-running the iteration."""


@dataclass
class RenderSupervisor:
    """Retrying driver for a progressive render loop.

    ``run(frame, start, iters, on_frame)`` calls ``frame(i)`` for each
    iteration and hands the result to ``on_frame(i, value)`` (the
    accumulation step).  If either raises, the supervisor calls
    ``checkpoint()`` (if given), synchronises the card and empties the
    allocator cache, waits ``backoff_s`` and retries the same iteration up
    to ``max_retries`` times before re-raising the last error.
    """

    max_retries: int = 1
    backoff_s: float = 2.0
    checkpoint: Callable[[], None] | None = None
    log: Callable[[str], None] = print
    failures: int = field(default=0, init=False)

    def run(self, frame: Callable[[int], Any], start: int, iters: int,
            on_frame: Callable[[int, Any], None]) -> None:
        for i in range(start, start + iters):
            attempts = 0
            while True:
                try:
                    on_frame(i, frame(i))
                    break
                except KeyboardInterrupt:
                    raise
                except Exception as e:  # noqa: BLE001 — any device fault
                    self.failures += 1
                    attempts += 1
                    self._salvage(i, e)
                    if attempts > self.max_retries:
                        raise
                    time.sleep(self.backoff_s)

    def _salvage(self, i: int, err: Exception) -> None:
        self.log(f"[Recover] iter {i + 1} failed: {type(err).__name__}: "
                 f"{err}")
        if self.checkpoint is not None:
            try:
                self.checkpoint()
                self.log("[Recover] accumulation checkpointed")
            except Exception as ce:  # noqa: BLE001
                self.log(f"[Recover] checkpoint also failed: {ce}")
        import torch

        if torch.cuda.is_available():
            try:
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            except Exception as ce:  # noqa: BLE001 — the retry will tell
                self.log(f"[Recover] synchronize failed: {ce}")
