"""The port's span recorder (utils/metrics.py) and the spans the tracker,
the System, StepGraphs and the read sites record, on the CPU at a small
stereo session (320x240 pairs of StepWallScene, 500 ORB features, 16
keyframes, 4096 points, a keyframe every 4 frames, loop closing on), and
on a card.

- Spans nest by thread: a span's parent is the innermost span open on
  its own thread; another thread starts its own tree.
- Event pairs resolve whenever a root span ends, and at most PENDING
  wait (a loop closer timing its stages outside any frame).
- Tracing off: the session records the stages it always recorded, and no
  span record and no event pair.
- Tracing on: one `frame.<kind>` sample a frame, the kinds agreeing with
  the tracker's counters; a `seg.<segment>` span for every StepGraphs run,
  under the stage that encloses it; no new sample under `track.` (the
  benchmark's track_step_ms sums those); a frame's segments inside its
  frame; the session's result unchanged.
- The clock: a span's ns are the profiler's (KinetoEvent.start_ns()).
- On a card (`cuda`): tracing adds no device->host read, and every
  `launch.<segment>` span gets its device time.

This module imports no jax, so its card test runs on a machine without it:
    python -m pytest --noconftest tests/test_torch_spans.py -m cuda
"""

import collections
import threading
import traceback
import warnings

import numpy as np
import pytest
import torch

from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.testing import StepWallScene, orbit_trajectory, render_stereo_frames
from tpuslam_torch.utils.metrics import Metrics, traced

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=350.0 * 0.12, width=320, height=240)
KW = dict(max_keyframes=16, max_points=4096, kf_max_frames=4)
N_FRAMES = 12
# The samples a session of this scenario records with tracing off: the
# stages the port has always timed.
STAGES = {"track.stereo_features", "track.dispatch", "track.fetch", "map.front", "map.local_ba1",
          "map.local_ba2", "map.normals", "map.loop", "loop.detect"}
# The stage each segment of the session runs under.
SEG_PARENT = {"front": {"track.stereo_features"}, "mm": {"track.dispatch"}, "ref": {"track.dispatch"},
              "local": {"track.dispatch"}, "kf_insert": {"frame"},
              "local_ba": {"map.local_ba1", "map.local_ba2"}, "normals": {"map.normals"}}
# Sample names the benchmark's stage readers take whole.
READ_WHOLE = {"map.front", "map.local_ba1", "map.local_ba2", "map.loop"}


def _frames():
    poses = orbit_trajectory(N_FRAMES, step=0.05)
    pairs = render_stereo_frames(StepWallScene(np.random.default_rng(5)), CAM, poses)
    return [(L.to(torch.uint8).numpy(), R.to(torch.uint8).numpy()) for L, R in pairs]


def _session(tracing: bool, device="cpu", on_frame=None):
    system = System(CAM, SensorType.STEREO, orb=ORBConfig(n_features=500), device=device, **KW)
    system.tracker.tracing = tracing
    outs = []
    for i, (L, R) in enumerate(_frames()):
        outs.append(system.track_stereo(L, R, i / 30.0) if on_frame is None
                    else on_frame(system, lambda: system.track_stereo(L, R, i / 30.0)))
    return system, outs


@pytest.fixture(scope="module")
def sessions():
    torch.set_num_threads(2)
    return {on: _session(on) for on in (False, True)}


def test_spans_nest_by_thread():
    m = Metrics()
    m.tracing = True
    seen = {}

    def worker():
        with m.trace("w.outer"), traced("w.inner"):
            pass

    with m.span("a"):
        with m.trace("b"):
            with traced("c"):
                pass
        t = threading.Thread(target=worker, name="mapper")
        t.start()
        t.join()
    with traced("nowhere"):  # no span open on this thread: nothing recorded
        pass
    for s in m.spans():
        seen[s["name"]] = s
    by_id = {s["id"]: s for s in seen.values()}
    assert set(seen) == {"a", "b", "c", "w.outer", "w.inner"}
    assert seen["a"]["parent"] is None
    assert by_id[seen["b"]["parent"]]["name"] == "a"
    assert by_id[seen["c"]["parent"]]["name"] == "b"
    # The other thread's stack is its own: its root has no parent although
    # "a" was open on the main thread.
    assert seen["w.outer"]["parent"] is None and seen["w.outer"]["thread"] == "mapper"
    assert by_id[seen["w.inner"]["parent"]]["name"] == "w.outer"
    assert seen["a"]["thread"] != "mapper"
    for s in seen.values():
        assert s["start_ns"] <= s["end_ns"]
        if s["parent"] is not None:
            p = by_id[s["parent"]]
            assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
    # A stage's sample is recorded whether or not the recorder traces; a
    # trace span's only while it does.
    m.tracing = False
    with m.span("a"), m.trace("b"):
        pass
    assert len(m.samples["a"]) == 2 and len(m.samples["b"]) == 1 and len(m.records) == 5


def test_spans_from_many_threads_keep_their_own_trees():
    """More threads than cores open nested spans on one recorder with the
    interpreter switching threads every few microseconds: every span's
    parent is its own thread's, every id is unique, no record is lost."""
    import sys

    m = Metrics()
    m.tracing = True
    n_threads, n_iter = 16, 200

    def worker():
        for _ in range(n_iter):
            with m.span("outer"), m.trace("middle"), traced("inner"):
                pass

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, name=f"w{i}") for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    spans = m.spans()
    assert len(spans) == 3 * n_threads * n_iter == len({s["id"] for s in spans})
    by_id = {s["id"]: s for s in spans}
    want = {"outer": None, "middle": "outer", "inner": "middle"}
    for s in spans:
        p = by_id.get(s["parent"])
        assert (p and p["name"]) == want[s["name"]] and (p is None or p["thread"] == s["thread"]), s
    assert all(len(m.samples[k]) == n_threads * n_iter for k in want)


def test_tracing_off_records_only_the_stages(sessions):
    system, _ = sessions[False]
    met = system.tracker.metrics
    assert not system.tracker.tracing
    assert set(met.samples) == STAGES
    assert len(met.records) == 0 and not met._pending and not met._free


def test_tracing_changes_nothing_of_the_session(sessions):
    (off, outs_off), (on, outs_on) = sessions[False], sessions[True]
    assert all(o is not None for o in outs_on)
    for a, b in zip(outs_off, outs_on):
        assert np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1])
    assert dict(off.tracker.metrics.counters) == dict(on.tracker.metrics.counters)
    for name in STAGES:
        assert len(on.tracker.metrics.samples[name]) == len(off.tracker.metrics.samples[name]), name


def test_tracing_on_labels_each_frame(sessions):
    system, _ = sessions[True]
    met = system.tracker.metrics
    frames = [s for s in met.spans() if s["name"] == "frame"]
    assert [s["frame"] for s in frames] == list(range(N_FRAMES))
    kinds = [s["kind"] for s in frames]
    # One frame.<kind> sample a frame.
    per_kind = {k[len("frame."):]: len(v) for k, v in met.samples.items() if k.startswith("frame.")}
    assert per_kind == dict(collections.Counter(kinds))
    c = met.counters
    assert kinds[0] == "init" and "lost" not in kinds and "retry" not in kinds
    assert sum(k.endswith(".kf") for k in kinds) == c["frames.keyframe"] >= 2
    assert sum(k.split(".")[0] == "mm" for k in kinds) == c["frames.motion_model"] > 0
    assert sum(k.split(".")[0] == "ref" for k in kinds) == c["frames.reference_kf"] > 0
    # Every span of a frame belongs to it (the uploads included: System
    # opens the frame around them).
    for s in met.spans():
        assert s["frame"] is not None, s
    assert len(met.samples["sys.upload"]) == 2 * N_FRAMES


def test_tracing_on_spans_every_graph_run_under_its_stage(sessions):
    system, _ = sessions[True]
    tr = system.tracker
    spans = tr.metrics.spans()
    by_id = {s["id"]: s for s in spans}
    segs = [s for s in spans if s["name"].startswith("seg.")]
    runs = tr.graphs.runs + tr.map_graphs.runs + tr.gba_graphs.runs
    if tr.loop_closer is not None and tr.loop_closer.graphs is not None:
        runs += tr.loop_closer.graphs.runs
    assert len(segs) == runs > 0
    for s in segs:
        p = by_id[s["parent"]]
        assert p["start_ns"] <= s["start_ns"] and s["end_ns"] <= p["end_ns"]
        seg = s["name"][len("seg."):]
        want = {"map.front"} if seg.startswith("map_") else SEG_PARENT[seg]
        assert p["name"] in want, (seg, p["name"])
    # On the CPU a run has no replay: no launch span, no device time.
    assert not any(k.startswith(("launch.", "dev.")) for k in tr.metrics.samples)
    # The reads of the frames and the keyframe jobs, each under its stage.
    parents = collections.defaultdict(set)
    for s in spans:
        if s["name"].startswith("read."):
            parents[s["name"]].add(by_id[s["parent"]]["name"])
    assert parents["read.verdict"] == {"track.dispatch"}
    assert parents["read.fetch"] == {"track.fetch"}
    assert parents["read.map_lengths"] == {"map.front"}
    assert parents["read.loop"] == {"loop.detect"}
    assert parents["read.compact"] == {"frame"}


def test_tracing_on_adds_no_track_sample_and_segments_fit_their_frame(sessions):
    (off, _), (on, _) = sessions[False], sessions[True]
    new = set(on.tracker.metrics.samples) - set(off.tracker.metrics.samples)
    assert {"sys.upload", "seg.front", "read.fetch"} <= new
    assert not any(n.startswith("track.") or n in READ_WHOLE for n in new), new
    per_frame = collections.defaultdict(float)
    frame_ns = {}
    for s in on.tracker.metrics.spans():
        if s["name"] == "frame":
            frame_ns[s["frame"]] = s["end_ns"] - s["start_ns"]
        elif s["name"].startswith("seg."):
            per_frame[s["frame"]] += s["end_ns"] - s["start_ns"]
    assert set(per_frame) <= set(frame_ns)
    for f, ns in per_frame.items():
        assert 0 < ns <= frame_ns[f], f


def test_span_ns_are_on_the_profilers_clock():
    """A span around a large product encloses the profiler's aten::mm
    event (KinetoEvent start_ns()..end_ns())."""
    from torch.profiler import ProfilerActivity, profile

    m = Metrics()
    m.tracing = True
    a = torch.randn(1024, 1024)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with m.trace("product"):
            torch.mm(a, a)
    (s,) = m.spans()
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert len(mm) == 1
    assert s["start_ns"] <= mm[0].start_ns() <= mm[0].end_ns() <= s["end_ns"]
    assert mm[0].end_ns() - mm[0].start_ns() > 0.5 * (s["end_ns"] - s["start_ns"])


def test_a_bare_loop_closer_resolves_and_bounds_its_event_pairs(monkeypatch):
    """A LoopCloser with stage_sync and no tracker opens its stages outside
    any frame: each stage is a root span, so its event pairs (and those of
    the replays inside it) resolve as it ends and are used again; it
    synchronizes once a stage; pairs that never complete stay at most
    PENDING. CUDA's events and streams are stand-ins, so this runs on the
    CPU."""
    from tpuslam_torch.pipeline.loop_closing import LoopCloser
    from tpuslam_torch.utils import metrics as metrics_module

    state = {"made": 0, "done": True, "syncs": 0}

    class Event:
        def __init__(self, enable_timing=False):
            state["made"] += 1

        def record(self, stream=None):
            pass

        def query(self):
            return state["done"]

        def elapsed_time(self, end):
            return 1.5

    class Stream:
        def synchronize(self):
            # The benchmark's read counter leaves out a synchronization whose
            # innermost frame of the package is a function named `_stage`.
            ours = [f for f in traceback.extract_stack() if "tpuslam_torch" in f.filename]
            state["syncs"] += ours[-1].name == "_stage"

    stream = Stream()
    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: stream)
    monkeypatch.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)
    monkeypatch.setattr(metrics_module, "PENDING", 8)
    lc = LoopCloser(16, fix_scale=False)
    lc.stage_sync = True
    met, dev = lc.metrics, torch.device("cuda")

    def closures(n):
        for _ in range(n):
            with lc._stage("loop.sim3", dev):
                with met.trace("launch.cg", device=dev, timed=True), traced("read.sim3"):
                    pass

    closures(50)
    assert not met._pending and state["made"] == 4
    assert met.samples["dev.loop.sim3"] == met.samples["dev.launch.cg"] == [1.5e-3] * 50
    assert state["syncs"] == 50 and len(met.samples["read.sim3"]) == 50
    state["done"] = False
    closures(50)
    assert len(met._pending) == 8
    assert len(met.samples["dev.loop.sim3"]) == 50 and len(met.records) == 300


@pytest.mark.cuda
def test_tracing_on_card_adds_no_read_and_times_every_launch():
    """The same frames on the card, tracing off and on: the same number of
    synchronizing calls (torch.cuda.set_sync_debug_mode) in each frame
    that captures no graph, and every launch.<segment> span resolved to its
    dev.launch.<segment>."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    counts, captured = {}, {}

    def captures(tr):
        lc = tr.loop_closer
        return sum(g.captures for g in (tr.graphs, tr.map_graphs, tr.gba_graphs,
                                        lc.graphs if lc is not None else None) if g is not None)

    def counted(system, track):
        before = captures(system.tracker)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                out = track()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        counts.setdefault(on, []).append(sum("synchroniz" in str(w.message) for w in caught))
        captured.setdefault(on, []).append(captures(system.tracker) > before)
        return out

    systems = {}
    for on in (False, True):
        torch.cuda.synchronize()
        systems[on], outs = _session(on, device="cuda", on_frame=counted)
        assert all(o is not None for o in outs), on
    # A frame that captures a graph synchronizes the device and empties the
    # allocator's cache, so its count depends on what earlier sessions of
    # the process left there: those frames are left out.
    assert captured[False] == captured[True], captured
    steady = [i for i, c in enumerate(captured[True]) if not c]
    assert len(steady) >= N_FRAMES // 2, captured
    assert [counts[False][i] for i in steady] == [counts[True][i] for i in steady], counts
    assert sum(counts[True][i] for i in steady) > 0, counts
    met = systems[True].tracker.metrics
    torch.cuda.synchronize()
    assert met.resolve() == 0
    launches = {k for k in met.samples if k.startswith("launch.")}
    assert "launch.local" in launches and "launch.front" in launches
    for k in launches:
        dev = met.samples["dev." + k]
        assert len(dev) == len(met.samples[k]) and all(x > 0 for x in dev), k
    for k in ("track.dispatch", "map.front"):
        assert len(met.samples["dev." + k]) == len(met.samples[k]), k
    # Host waits carry no event pair.
    assert not any(k.startswith(("dev.read.", "dev.sys.", "dev.seg.", "dev.frame")) for k in met.samples)
    assert not systems[False].tracker.metrics.records
