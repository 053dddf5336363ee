"""Fault tolerance: heartbeats, straggler detection, supervised restart.

A copy of ``repro/runtime/fault_tolerance.py`` (plain Python).

At 1000+ nodes, three failure modes dominate; each maps to a mechanism here:

* hard node failure      → supervisor (launch/train.py --supervise) re-execs
                           the job; restart resumes from the last committed
                           checkpoint + data cursor (bitwise replay).
* straggling node        → StepMonitor flags steps slower than mean + k·σ
                           (EWMA); the launcher logs/exports the signal so a
                           cluster scheduler can drain-and-replace the host.
* hung collective        → watchdog thread aborts the process if no step
                           completes within ``hang_timeout_s`` — turning a
                           silent hang into a supervised restart.
"""
from __future__ import annotations

import dataclasses
import json
import os
import threading
import time
from typing import Callable, List, Optional


@dataclasses.dataclass
class StepStats:
    step: int
    duration_s: float
    is_straggler: bool
    ewma_s: float


class StepMonitor:
    """EWMA step-time tracker with straggler flagging."""

    def __init__(self, alpha: float = 0.1, k_sigma: float = 3.0,
                 warmup_steps: int = 5):
        self.alpha = alpha
        self.k = k_sigma
        self.warmup = warmup_steps
        self.ewma: Optional[float] = None
        self.ewvar: float = 0.0
        self.n = 0
        self.history: List[StepStats] = []

    def record(self, step: int, duration_s: float) -> StepStats:
        self.n += 1
        if self.ewma is None:
            self.ewma = duration_s
        delta = duration_s - self.ewma
        straggler = False
        if self.n > self.warmup:
            sigma = max(self.ewvar, 1e-12) ** 0.5
            straggler = delta > self.k * sigma and delta > 0.05 * self.ewma
        self.ewma += self.alpha * delta
        self.ewvar = (1 - self.alpha) * (self.ewvar
                                         + self.alpha * delta * delta)
        st = StepStats(step, duration_s, straggler, self.ewma)
        self.history.append(st)
        return st


class Heartbeat:
    """Periodic liveness file for external supervisors; also an in-process
    watchdog that aborts on hang (no `beat()` within hang_timeout_s)."""

    def __init__(self, path: str, interval_s: float = 10.0,
                 hang_timeout_s: float = 0.0,
                 on_hang: Optional[Callable[[], None]] = None):
        self.path = path
        self.interval = interval_s
        self.hang_timeout = hang_timeout_s
        self.on_hang = on_hang or (lambda: os._exit(42))
        self._last_beat = time.monotonic()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def beat(self, step: int = -1):
        self._last_beat = time.monotonic()
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"time": time.time(), "step": step,
                       "pid": os.getpid()}, f)
        os.replace(tmp, self.path)

    def _worker(self):
        while not self._stop.wait(self.interval):
            if (self.hang_timeout
                    and time.monotonic() - self._last_beat > self.hang_timeout):
                self.on_hang()

    def close(self):
        self._stop.set()


def supervise(run_fn: Callable[[], int], max_restarts: int = 100,
              backoff_s: float = 5.0, log=print) -> int:
    """In-process supervisor: call ``run_fn`` until it returns 0 or the
    restart budget is exhausted. ``run_fn`` is expected to resume from the
    latest checkpoint on re-entry."""
    for attempt in range(max_restarts + 1):
        try:
            rc = run_fn()
        except Exception as e:  # noqa: BLE001 — any crash triggers restart
            log(f"[supervisor] run crashed ({type(e).__name__}: {e}); "
                f"attempt {attempt + 1}/{max_restarts}")
            rc = 1
        if rc == 0:
            return 0
        if attempt == max_restarts:
            break
        time.sleep(backoff_s)
        log(f"[supervisor] restarting (attempt {attempt + 1})")
    return 1
