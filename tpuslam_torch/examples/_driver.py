"""What the dataset drivers share: feeding a sequence to a System with the
decode and the tracking timed apart, and the closing report."""

from __future__ import annotations

import time
from typing import NamedTuple

import numpy as np
import torch


class DriverRun(NamedTuple):
    """A driver's result: the System (its map and trajectory), and per
    frame the host's decode time and the tracking time in ms (the card
    synchronized after each frame)."""

    system: object
    decode_ms: list
    track_ms: list


def drive(system, seq, track) -> DriverRun:
    """track(item) for every item of `seq` (an iterator that decodes as it
    goes)."""
    dev = system.tracker.device
    decode_ms, track_ms = [], []
    it = iter(seq)
    while True:
        t0 = time.perf_counter()
        item = next(it, None)
        if item is None:
            break
        t1 = time.perf_counter()
        track(item)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        decode_ms.append((t1 - t0) * 1e3)
        track_ms.append((time.perf_counter() - t1) * 1e3)
    return DriverRun(system, decode_ms, track_ms)


def report(res: DriverRun, out: str) -> None:
    if res.track_ms:
        print(f"median tracking time: {np.median(res.track_ms):.1f} ms, "
              f"median decode time: {np.median(res.decode_ms):.1f} ms")
    print(res.system.map_stats())
    print(f"trajectory saved to {out}")
