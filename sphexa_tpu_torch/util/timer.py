"""Per-substage wall-clock timing, analog of the reference Timer
(reference: main/src/util/timer.hpp:30-85). Stages are recorded per
iteration and can be printed or dumped for profiling.

Counterpart of sphexa_tpu/util/timer.py, the same host-clock code."""

from __future__ import annotations

import time
from collections import defaultdict


class StageTimer:
    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self.totals = defaultdict(float)
        self.current = {}
        self._t0 = None

    def start(self):
        if self.enabled:
            self.current = {}
            self._t0 = time.perf_counter()

    def step(self, name: str):
        if not self.enabled:
            return
        t = time.perf_counter()
        dt = t - self._t0
        self.current[name] = self.current.get(name, 0.0) + dt
        self.totals[name] += dt
        self._t0 = t

    def iteration_report(self) -> str:
        return " ".join(f"{k}: {v * 1e3:.1f}ms" for k, v in self.current.items())

    def summary(self) -> dict:
        return dict(self.totals)
