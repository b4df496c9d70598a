"""The arithmetic of the end-to-end metrics and of a set's spread."""

from __future__ import annotations

import statistics

import numpy as np


def window_metrics(latencies_s, window_s: float) -> dict:
    """frames_per_s: frames whose pose came back in the window over the
    window's wall time (all the work over all the time, so a stall counts);
    frame_ms_p50 / p95: the median and 95th percentile of every frame's
    latency, handing to pose (numpy's linear interpolation)."""
    lat_ms = np.asarray(latencies_s, np.float64) * 1e3
    if lat_ms.size == 0 or window_s <= 0:
        raise ValueError("no frame completed in the window")
    return {"frames_per_s": lat_ms.size / window_s,
            "frame_ms_p50": float(np.percentile(lat_ms, 50)),
            "frame_ms_p95": float(np.percentile(lat_ms, 95))}


def spread(values) -> float:
    """Distance between the first and the third quartile as a share of the
    median (statistics.quantiles, n=4)."""
    q1, med, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / med
