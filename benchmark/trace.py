"""What the traced run reads: the device->host reads of the program
(torch.cuda.set_sync_debug_mode), and a profiler slice of frames (device
activity, its union, kernel times by name, idle gaps by what the host was
doing).

`SyncCounter` is a copy of chip_smoke.py's sync_sites (commit 431b9431):
each synchronising CUDA call torch reports is charged to the innermost
frame of the program on its stack. It counts only while `counting` is set,
so the benchmark's own reads (rendering, the profiler) are left out, and it
leaves out the synchronisations the tracker's stage timers make when
stage_sync is on (a frame in its `_stage`), which exist only in the traced
run.
"""

from __future__ import annotations

import threading
import traceback
import warnings
from pathlib import Path

import torch

PROGRAM_DIR = "tpuslam_torch"
STAGE_SYNC_FUNCS = ("_stage",)


class SyncCounter:
    def __init__(self):
        self.counting = False
        self.sites = []
        self._saved = None

    def _record(self, message, category, filename, lineno, file=None, line=None):
        if not self.counting or "synchroniz" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1] if not f.filename.endswith("warnings.py")]
        ours = [f for f in stack if f"{PROGRAM_DIR}/" in f.filename.replace("\\", "/")]
        if ours and ours[-1].name in STAGE_SYNC_FUNCS:
            return
        where = ours[-1:] or stack[::-1][:3]
        th = threading.current_thread()
        tag = "" if th is threading.main_thread() else f"{th.name}: "
        self.sites.append(tag + " < ".join(f"{Path(f.filename).name}:{f.lineno} ({f.name})" for f in where))

    def __enter__(self):
        torch.cuda.synchronize()
        self._catch = warnings.catch_warnings()
        self._catch.__enter__()
        warnings.simplefilter("always")
        self._saved = warnings.showwarning
        warnings.showwarning = self._record
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        warnings.showwarning = self._saved
        self._catch.__exit__(*exc)
        return False


class Slice:
    """A torch.profiler session over a slice of frames, CPU and CUDA
    activity. `close()` stops it and keeps the raw events (no chrome trace
    is written)."""

    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.events = None

    def open(self):
        torch.cuda.synchronize()
        self.prof.__enter__()

    def close(self):
        torch.cuda.synchronize()
        self.prof.__exit__(None, None, None)
        self.events = self.prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA


def device_intervals(events) -> list:
    """(start_ns, end_ns, name) of every device activity (kernels, copies,
    fills), in start order."""
    out = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
           if _is_device(e) and e.duration_ns() > 0]
    return sorted(out)


def union(intervals) -> tuple:
    """(busy ns of the union of the intervals, [(gap start, gap end)])."""
    busy, gaps, cur_s, cur_e = 0, [], None, None
    for s, e, _ in intervals:
        if cur_e is None:
            cur_s, cur_e = s, e
        elif s > cur_e:
            busy += cur_e - cur_s
            gaps.append((cur_e, s))
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy, gaps


def by_name(intervals) -> dict:
    """name -> [summed ns, count]."""
    out = {}
    for s, e, n in intervals:
        acc = out.setdefault(n, [0, 0])
        acc[0] += e - s
        acc[1] += 1
    return out


def host_at(events, t_ns: int) -> str:
    """The innermost host operation running at t_ns (the latest started of
    those that span it), or "idle host"."""
    best = None
    for e in events:
        if _is_device(e):
            continue
        s = e.start_ns()
        if s <= t_ns <= s + e.duration_ns() and (best is None or s > best[0]):
            best = (s, e.name())
    return best[1] if best else "idle host"


def breakdown(events, intervals, gaps, top: int = 10) -> dict:
    """The `breakdown` of the result line: the device operations that took
    most time in the slice, and the longest idle gaps named by what the
    host was doing in their middle; seconds."""
    ops = sorted(by_name(intervals).items(), key=lambda kv: -kv[1][0])[:top]
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    return {"device_ops": [[n[:120], v[0] / 1e9] for n, v in ops],
            "idle_gaps": [[host_at(events, (a + b) // 2)[:120], (b - a) / 1e9] for a, b in longest]}
