"""Per-phase wall times.  Counterpart of ``fresco_tpu/utils/profiling.py``.

``PhaseTimes`` sums seconds and counts per phase under a lock: the
keyframe runner's prep thread times batch k+1's phases while the main
thread times batch k's denoise loop.  ``phase_timer`` times a block and,
when asked, synchronizes the CUDA device at its end, so the phase holds
the device work it queued rather than only its launch time, and opens the
profiler range ``fresco::<phase>`` around the block, so that each phase
shows in a device trace on the profiler's clock.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import defaultdict

import torch
from torch.profiler import record_function


class PhaseTimes:
    """Accumulated per-phase wall seconds and call counts; thread-safe."""

    def __init__(self):
        self.times: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self._lock = threading.Lock()

    def add(self, name: str, dt: float) -> None:
        with self._lock:
            self.times[name] += dt
            self.counts[name] += 1

    def report(self) -> str:
        with self._lock:
            items = sorted(self.times.items(), key=lambda kv: -kv[1])
            lines = [f"  {k:<28s} {v:8.3f}s  x{self.counts[k]}" for k, v in items]
        return "phase times:\n" + "\n".join(lines)


@contextlib.contextmanager
def phase_timer(phases: PhaseTimes, name: str, device: torch.device | None = None):
    """Time a block into ``phases[name]`` inside the profiler range
    ``fresco::<name>``; with a CUDA ``device``, wait for the device's queued
    work before reading the clock.  Phases nest as their blocks do."""
    with record_function(f"fresco::{name}"):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if device is not None and device.type == "cuda":
                torch.cuda.synchronize(device)
            phases.add(name, time.perf_counter() - t0)
