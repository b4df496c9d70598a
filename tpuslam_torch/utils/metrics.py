"""Counters and spans for a SLAM session, and a profiler trace. Port of
tpuslam/utils/metrics.py, grown into a span recorder.

A span times a named piece of work on the host: its seconds on
perf_counter go to `samples[name]`. Spans nest: each has a parent, the
innermost span open on the same thread (every thread keeps its own stack,
so the tracking thread, the mapping thread and the global-BA thread each
build their own tree).

`span(name)` is a stage: it records its sample whether or not the
recorder is tracing (the tracker's `track.*`, `map.*`, `init.*`, the loop
closer's `loop.*`, the graphs' `*.capture`). `trace(name)` is a span that
exists only while `tracing` is on: off, it tests one attribute and hands
back a shared no-op context, and records nothing. `traced(name)` is
`trace` on the recorder of the calling thread's innermost open span, for
a site that has no recorder at hand (a device->host read inside a
composed step).

With tracing on, every span also keeps a record (`Span`) in a bounded
ring buffer, `records`: name, parent, thread, frame id and kind, host
start and end in ns on time.time_ns(), the clock of torch.profiler's
events (KinetoEvent.start_ns()), so that a span lays over a device trace.
A timed span (a stage, unless made with timed=False; a trace span made
with timed=True: a graph replay) on a CUDA device also records a timing
event pair on the current stream at its start and end (never while that
stream is capturing a graph). A host wait (a read, an upload) has no
pair: it would time the copy behind whatever the stream held, and each
pair costs the frame some microseconds. `resolve()` reads only the pairs
whose end event has completed (Event.query(); no synchronization) and
appends each elapsed time, in seconds like every sample, to
`samples["dev." + name]`: the stream's time from the span's start to its
end. Pairs not done yet wait for a later call. It runs whenever a root
span ends (a frame, a mapping job, a loop closer's stage outside any
frame), and at most PENDING pairs wait: beyond, the oldest is dropped
unread.

Device work is asynchronous, so a span's host time is its launch cost
unless the caller synchronizes at its end. `stage_sync` (shared by a
tracker and its loop closer, whose properties set it here) makes every
stage opened with `span(..., sync=True)` synchronize the calling thread's
stream at its end, and turns tracing on too. Tracing alone never
synchronizes.

`torch_trace` traces a block with torch.profiler and writes it as a
Chrome trace, with a recorder's spans of the block beside the kernels.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from collections import defaultdict

import torch

RECORDS = 1 << 16  # the ring buffer's bound: the newest spans kept
PENDING = 1 << 12  # event pairs waiting to be resolved, at most

_tls = threading.local()  # .stack: the calling thread's open spans, innermost last
_NULL = contextlib.nullcontext()


def _stack() -> list:
    st = getattr(_tls, "stack", None)
    if st is None:
        st = _tls.stack = []
    return st


def traced(name: str):
    """`trace(name)` on the recorder of the calling thread's innermost open
    span; the no-op where no span is open (spans open only while their
    recorder traces)."""
    st = getattr(_tls, "stack", None)
    return st[-1].metrics.trace(name) if st else _NULL


def _stage(dev):
    """A stage's synchronization under stage_sync: the calling thread's
    current stream on `dev`, a CUDA device (nothing elsewhere). The
    benchmark's read counter (benchmark/trace.py) tells these apart from
    the program's reads by this function's name: keep it."""
    if dev is not None and dev.type == "cuda":
        torch.cuda.current_stream(dev).synchronize()


class Span:
    """One span, a context manager of its recorder, and its record once it
    has ended. `parent` is the enclosing span on its thread (None for a
    root); `frame` the frame span open when it began (on any thread), whose
    `frame_id` and `kind` it belongs to; `device_ms` the elapsed time of
    its event pair once resolved (None before, and without a pair)."""

    __slots__ = ("metrics", "name", "id", "parent", "thread", "frame", "frame_id", "kind",
                 "start_ns", "end_ns", "device_ms", "_sample", "_timed", "_device", "_sync", "_t0",
                 "_pair")

    def __init__(self, metrics, name: str, sample: str, timed: bool, device, sync: bool = False):
        self.metrics, self.name, self._sample = metrics, name, sample
        self._timed, self._device, self._sync = timed, device, sync
        self.frame_id = self.kind = self.device_ms = self._pair = None

    def __enter__(self):
        self.metrics._begin(self)
        return self

    def __exit__(self, exc_type, *exc):
        self.metrics._end(self, exc_type is None)
        return False

    def as_dict(self) -> dict:
        f = self.frame
        return {"id": self.id, "name": self.name, "parent": None if self.parent is None else self.parent.id,
                "thread": self.thread, "frame": None if f is None else f.frame_id,
                "kind": None if f is None else f.kind, "start_ns": self.start_ns,
                "end_ns": self.end_ns, "device_ms": self.device_ms}


class Metrics:
    """Counters and spans for a SLAM session. `device` is where the spans'
    event pairs go (a CUDA device; None or the CPU: none)."""

    def __init__(self, device=None):
        self.counters = defaultdict(int)
        self.samples = defaultdict(list)
        self.device = None if device is None else torch.device(device)
        self.records = collections.deque(maxlen=RECORDS)
        self._on = False      # the one attribute a span site tests: tracing or stage_sync
        self._traced = False
        self._sync = False
        self._frame = None    # the open frame span
        self._pending = []    # spans whose event pair is not resolved yet
        self._free = {}       # device -> [(start, end)] events to use again
        self._lock = threading.Lock()
        self._ids = itertools.count()

    def __getstate__(self):
        """Copies and pickles keep the counters, the samples and the
        switches; not the span records, the event pairs, the lock or an
        open frame."""
        state = dict(self.__dict__)
        state.update(records=None, _frame=None, _pending=[], _free={}, _lock=None, _ids=None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.records = collections.deque(maxlen=RECORDS)
        self._lock = threading.Lock()
        self._ids = itertools.count()

    @property
    def timer(self):
        """The samples' old holder: `timer.samples` is `samples`."""
        return self

    @property
    def tracing(self) -> bool:
        """Spans keep records, event pairs and `trace` samples: set, or
        on with stage_sync."""
        return self._on

    @tracing.setter
    def tracing(self, on: bool):
        self._traced = bool(on)
        self._on = self._traced or self._sync

    @property
    def stage_sync(self) -> bool:
        """Spans opened with sync=True (the stages of a tracker and its
        loop closer) synchronize their stream at their end, so their
        samples hold device time; on, it turns tracing on too."""
        return self._sync

    @stage_sync.setter
    def stage_sync(self, on: bool):
        self._sync = bool(on)
        self._on = self._traced or self._sync

    def inc(self, name: str, by: int = 1):
        self.counters[name] += by

    def span(self, name: str, device=None, timed: bool = True, sync: bool = False):
        """A stage named `name`: its host seconds go to samples[name]; with
        tracing on, it is a Span (its event pair on `device`, a
        torch.device, else the recorder's, unless `timed` is False). With
        `sync` and stage_sync on, a CUDA device's current stream of the
        calling thread (not the device: a mapping stage must not wait for
        tracking) is synchronized as the span ends, inside its time."""
        if self._on:
            return Span(self, name, name, timed, device, sync)
        return self._clock(name)

    @contextlib.contextmanager
    def _clock(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.samples[name].append(time.perf_counter() - t0)

    def trace(self, name: str, device=None, timed: bool = False):
        """A span that exists only with tracing on; the no-op otherwise."""
        return Span(self, name, name, timed, device) if self._on else _NULL

    @contextlib.contextmanager
    def frame(self, frame_id: int):
        """The root span `frame` of one frame, with tracing on and no frame
        open; yields it (None otherwise). The caller sets its `kind`; at its
        end its host seconds go to samples["frame." + kind] (a root span, it
        resolves the finished event pairs as it ends)."""
        if not self._on or self._frame is not None:
            yield None
            return
        sp = Span(self, "frame", None, False, None)
        sp.frame_id = frame_id
        with sp:
            sp.frame = self._frame = sp
            try:
                yield sp
            finally:
                self._frame = None
                if sp.kind is not None:
                    sp._sample = "frame." + sp.kind

    def _begin(self, sp: Span):
        st = _stack()
        sp.id = next(self._ids)
        sp.parent = st[-1] if st else None
        sp.thread = threading.current_thread().name
        sp.frame = self._frame
        st.append(sp)
        dev = sp._device if sp._device is not None else self.device
        if sp._timed and dev is not None and dev.type == "cuda":
            stream = torch.cuda.current_stream(dev)
            if not torch.cuda.is_current_stream_capturing():
                pair = self._pair(dev)
                pair[0].record(stream)
                sp._pair = (pair, stream, dev)
        sp.start_ns = time.time_ns()
        sp._t0 = time.perf_counter()

    def _end(self, sp: Span, ok: bool = True):
        if sp._sync and ok and self._sync:
            _stage(sp._device if sp._device is not None else self.device)
        t1 = time.perf_counter()
        sp.end_ns = time.time_ns()
        if sp._pair is not None:
            (_, end), stream, _ = sp._pair
            end.record(stream)
            with self._lock:
                self._pending.append(sp)
                while len(self._pending) > PENDING:
                    self._pending.pop(0)._pair = None
        st = _stack()
        if st and st[-1] is sp:
            st.pop()
        elif sp in st:
            st.remove(sp)
        if sp._sample is not None:
            self.samples[sp._sample].append(t1 - sp._t0)
        self.records.append(sp)
        if sp.parent is None:
            self.resolve()

    def _pair(self, dev) -> tuple:
        with self._lock:
            free = self._free.get(dev)
            if free:
                return free.pop()
        return torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def resolve(self) -> int:
        """Read the event pairs whose end event has completed, without a
        synchronization: each span's `device_ms`, and its seconds appended
        to samples["dev." + name]. Returns how many pairs still wait."""
        if not self._pending:
            return 0
        with self._lock:
            pending, self._pending = self._pending, []
        wait, done = [], []
        for sp in pending:
            (start, end), _, dev = sp._pair
            if not end.query():
                wait.append(sp)
                continue
            sp.device_ms = start.elapsed_time(end)
            self.samples["dev." + sp.name].append(sp.device_ms / 1e3)
            sp._pair = None
            done.append((dev, (start, end)))
        with self._lock:
            self._pending[:0] = wait
            for dev, pair in done:
                self._free.setdefault(dev, []).append(pair)
        return len(wait)

    def spans(self, since_ns: int = 0) -> list:
        """The buffer's records that began at or after `since_ns`, as dicts,
        in the order they ended."""
        return [sp.as_dict() for sp in list(self.records) if sp.start_ns >= since_ns]


def _write_spans(path: str, spans: list):
    """Append `spans` (Metrics.spans dicts) to the Chrome trace at `path`
    as complete events of a process of their own, one row a thread, on
    the trace's clock (its baseTimeNanoseconds)."""
    with open(path) as f:
        doc = json.load(f)
    events, base = doc["traceEvents"], doc.get("baseTimeNanoseconds", 0)
    pid = "tpuslam_torch spans"
    events.append({"ph": "M", "name": "process_name", "pid": pid, "args": {"name": pid}})
    for s in spans:
        args = {k: s[k] for k in ("id", "parent", "frame", "kind", "device_ms") if s[k] is not None}
        events.append({"ph": "X", "cat": "span", "name": s["name"], "pid": pid, "tid": s["thread"],
                       "ts": (s["start_ns"] - base) / 1e3, "dur": (s["end_ns"] - s["start_ns"]) / 1e3,
                       "args": args})
    with open(path, "w") as f:
        json.dump(doc, f)


@contextlib.contextmanager
def torch_trace(logdir: str, metrics: Metrics = None):
    """Trace the block with torch.profiler (host and, where the build has
    it, CUDA activity) and write it into `logdir` as a Chrome trace
    (chrome://tracing or Perfetto; no TensorBoard plugin). With `metrics`,
    that recorder traces during the block and the spans it records there
    are written into the same file, on the kernels' timeline. Yields the
    profiler: its key_averages() and events() stay readable after the
    block, and its `trace_path` names the file."""
    from torch.profiler import profile, supported_activities

    os.makedirs(logdir, exist_ok=True)
    prof = profile(activities=list(supported_activities()))
    prof.trace_path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    was = metrics._traced if metrics is not None else None
    t0 = time.time_ns()
    try:
        if metrics is not None:
            metrics.tracing = True
        with prof:
            yield prof
    finally:
        if metrics is not None:
            metrics.tracing = was
        prof.export_chrome_trace(prof.trace_path)
        if metrics is not None:
            _write_spans(prof.trace_path, metrics.spans(t0))
