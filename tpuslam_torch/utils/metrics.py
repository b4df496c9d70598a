"""Per-stage timing and counters (numpy only). Port of
tpuslam/utils/metrics.py: host wall-clock around each stage; device work
is asynchronous, so a stage's time is its launch cost unless the caller
synchronizes at the stage's end."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import numpy as np


class StageTimer:
    def __init__(self):
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def summary(self) -> dict:
        out = {}
        for name, xs in self.samples.items():
            arr = np.asarray(xs)
            out[name] = {
                "n": len(arr),
                "median_ms": float(np.median(arr) * 1e3),
                "mean_ms": float(np.mean(arr) * 1e3),
                "p90_ms": float(np.percentile(arr, 90) * 1e3),
            }
        return out


class Metrics:
    """Counters and timers for a SLAM session."""

    def __init__(self):
        self.counters = defaultdict(int)
        self.timer = StageTimer()

    def inc(self, name: str, by: int = 1):
        self.counters[name] += by

    def stage(self, name: str):
        return self.timer.stage(name)

    def report(self) -> dict:
        return {"counters": dict(self.counters), "stages": self.timer.summary()}
