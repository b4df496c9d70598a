"""Per-stage timing and counters, and a profiler trace. Port of
tpuslam/utils/metrics.py: host wall-clock around each stage; device work
is asynchronous, so a stage's time is its launch cost unless the caller
synchronizes at the stage's end. `torch_trace` (the counterpart of
jax_trace) imports torch when it is entered; the rest is numpy only."""

from __future__ import annotations

import contextlib
import os
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


@contextlib.contextmanager
def torch_trace(logdir: str):
    """Trace the block with torch.profiler (host and, where the build has
    it, CUDA activity) and write it into `logdir` as a Chrome trace
    (chrome://tracing or Perfetto; no TensorBoard plugin). Yields the
    profiler: its key_averages() and events() stay readable after the
    block, and its `trace_path` names the file."""
    from torch.profiler import profile, supported_activities

    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=list(supported_activities()))
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    try:
        with prof:
            yield prof
    finally:
        prof.export_chrome_trace(prof.trace_path)
