"""The LocalMapping programs through StepGraphs (pipeline/graphs.py): the
segments of mapping_front (steps.compose_mapping_front), the local-BA
chunks (steps.local_ba_segment), the normals, point compaction and
keyframe insertion, as the Tracker runs them (Tracker.map_graphs; keyframe
insertion through Tracker.graphs, on the tracking thread). On the CPU at
test_torch_mapping.py's state (320x240, 500 features, 16 keyframes of 1000
keypoint slots, 4096 points: the input of a monocular session's last
keyframe job), and on a card.

- The StepGraphs route (static buffers on the CPU, graph replays on a card)
  equals the eager route (every segment through call_segment) bit for bit,
  and still matches the JAX package's function within the tolerances of
  test_torch_mapping.py (stated at each comparison).
- Each segment runs on meta tensors with no device->host read, no copy
  between the host and the device, and no input modified.
- The keys of a keyframe job do not depend on the keyframe, the neighbour
  count or the fuse-pair count.
- A mono session maps through map_graphs bit-equal to the same session
  mapped eagerly; under async_mapping the mapping thread runs map_graphs
  and never the tracking thread's graphs.

This module imports no jax at its top (the JAX comparisons import it), so
its card tests run on a machine without it:
    python -m pytest --noconftest tests/test_torch_mapping_graphs.py -m cuda
"""

import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuslam_torch.convert import map_to_numpy, map_to_torch
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.mapstate.core import FrameFeatures
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline import steps
from tpuslam_torch.pipeline.graphs import StepGraphs, _flatten, call_segment
from tpuslam_torch.pipeline.system import System
from tpuslam_torch.testing import (
    StepWallScene,
    keep_mapping_inputs,
    mono_session,
    orbit_trajectory,
    render_frames,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_graph_paths import _runs_on_meta  # noqa: E402  (the meta-tensor rules)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)
ORB = ORBConfig(n_features=500)
N_FRAMES = 14
SF, NL = 1.2, 8
SESSION = dict(orb=ORB, max_keyframes=16, max_points=4096, kf_max_frames=10, enable_loop_closing=False)
# The LocalMapping settings: monocular (20 neighbours both ways, points
# seen by 3 keyframes) and a depth sensor's (10, 2).
FRONT = {"mono": (20, 3.0), "depth": (10, 2.0)}
FRONT_SEGMENTS = {"map_head", "map_tri", "map_insert", "map_fuse", "map_fuse_apply", "map_tail"}


def _frames(device="cpu"):
    return render_frames(StepWallScene(np.random.default_rng(11)), CAM,
                         orbit_trajectory(N_FRAMES, step=0.045), device=device)


def _session(device="cpu", eager=False, **cfg):
    """A mono session (test_torch_mapping.py's), its mapping through the
    tracker's map_graphs, or eagerly. Returns (system, every keyframe job's
    input (map, slot) by job index, the per-frame outputs)."""
    system = System(CAM, device=device, **SESSION, **cfg)
    if eager:
        system.tracker.map_graphs.run = call_segment
    kept = keep_mapping_inputs(system.tracker)
    res = mono_session(system, _frames(device))
    return system, kept, [out for out, _ in res]


@pytest.fixture(scope="module")
def snap():
    """(system, its keyframe jobs' inputs, its outputs): the session mapped
    through the tracker's map_graphs."""
    system, kept, outs = _session()
    m, ki = kept[max(kept)]
    assert ki >= 4 and int(m.kf_valid.sum()) >= 5
    return system, kept, outs


def _last_job(snap):
    system, kept, _ = snap
    return system, *kept[max(kept)]


def _front(m, ki, inv_s2, setting, run=call_segment):
    nn, min_obs = FRONT[setting]
    return steps.mapping_front(CAM, m, ki, inv_s2, min_obs, scale_factor=SF, n_levels=NL, nn_tri=nn,
                               nn_fuse=nn, fuse_hop=5, window=8, run=run)


def _maps_equal(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), name


def _jax_map(m):
    import jax.numpy as jnp

    from tpuslam.mapstate import core as jcore
    return jcore.MapState(*(jnp.asarray(x) for x in map_to_numpy(m)))


@pytest.mark.parametrize("setting", list(FRONT))
def test_mapping_front_graphed_equals_eager_and_matches_jax(snap, setting):
    """Through a CPU StepGraphs, as the tracker runs it: torch.equal to the
    eager composition on every field. Against the JAX mapping_front
    (test_mapping_front_matches_jax's tolerances): keyframe validity,
    parents, watermarks and the new points' keyframes equal; the
    observation table in >= 99% of its live entries, point validity in
    >= 99.5% (fusion's octave edges); points within 1e-3, relative
    rotations within 1e-5."""
    import jax
    import jax.numpy as jnp

    from tpuslam.geometry.camera import PinholeCamera as JCamera
    from tpuslam.pipeline import steps as jsteps

    system, m, ki = _last_job(snap)
    inv_s2 = system.tracker.inv_sigma2
    graphs, ran = StepGraphs("cpu"), []

    def run(name, fn, static, **inputs):
        ran.append(name)
        return graphs.run(name, fn, static, **inputs)

    got = _front(m, ki, inv_s2, setting, run)
    _maps_equal(got, _front(m, ki, inv_s2, setting))
    assert set(ran) == FRONT_SEGMENTS and ran.count("map_tri") >= 1 and ran.count("map_fuse") >= 2

    nn, min_obs = FRONT[setting]
    with jax.disable_jit():
        ref = jsteps.mapping_front(JCamera(**CAM._asdict()), _jax_map(m), jnp.int32(ki),
                                   jnp.asarray(inv_s2.numpy()), jnp.float32(min_obs), scale_factor=SF,
                                   n_levels=NL, nn_tri=nn, nn_fuse=nn, fuse_hop=5, window=8)
    ref = map_to_torch(ref, "cpu")
    for name in ("kf_valid", "kf_parent", "n_kf", "n_pt", "pt_first_kf", "pt_ref_kf"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), getattr(ref, name).numpy(), err_msg=name)
    live = (got.kf_obs_pt >= 0) | (ref.kf_obs_pt >= 0)
    assert float((got.kf_obs_pt == ref.kf_obs_pt)[live].float().mean()) >= 0.99
    assert float((got.pt_valid == ref.pt_valid).float().mean()) >= 0.995
    both = got.pt_valid & ref.pt_valid
    np.testing.assert_allclose(got.pt_xyz[both].numpy(), ref.pt_xyz[both].numpy(), rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(got.kf_rel_R.numpy(), ref.kf_rel_R.numpy(), atol=1e-5)
    assert int(got.n_pt) > int(m.n_pt)  # it triangulated


@pytest.mark.parametrize("max_edges", [0, 3000])
def test_local_ba_segment_equals_eager_and_matches_jax(snap, max_edges):
    """local_ba_segment through a CPU StepGraphs, the centre a 1-element
    tensor, equals the eager local_bundle_adjustment on a host int; against
    JAX within test_local_bundle_adjustment_matches_jax's tolerance
    (integers equal, floats within 2e-4)."""
    import jax
    import jax.numpy as jnp

    from tpuslam.geometry.camera import PinholeCamera as JCamera
    from tpuslam.pipeline import steps as jsteps

    system, m, ki = _last_job(snap)
    inv_s2 = system.tracker.inv_sigma2
    kw = dict(window=8, iters=4, n_levels=NL, max_edges=max_edges, active_max=6)
    part = StepGraphs("cpu").run("local_ba", steps.local_ba_segment, dict(cam=CAM, **kw),
                                 m=steps.map_fields(m, steps.LOCAL_BA_FIELDS),
                                 center_kf=torch.full((1,), ki), inv_sigma2_table=inv_s2)
    assert {k for k, v in part._asdict().items() if v is not None} == set(steps.LOCAL_BA_CHANGED)
    got = steps.merge_fields(m, part)
    _maps_equal(got, steps.local_bundle_adjustment(CAM, m, ki, inv_s2, **kw))
    with jax.disable_jit():
        ref = jsteps.local_bundle_adjustment(JCamera(**CAM._asdict()), _jax_map(m), jnp.int32(ki),
                                             jnp.asarray(inv_s2.numpy()), **kw)
    ref = map_to_numpy(map_to_torch(ref, "cpu"))
    for name, a, b in zip(got._fields, map_to_numpy(got), ref):
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            np.testing.assert_allclose(a, b, rtol=2e-4, atol=2e-4, err_msg=name)
    assert not torch.equal(got.kf_R, m.kf_R)


def _record_job(tracker, m, ki) -> dict:
    """{segment: (fn, static, inputs)} of one keyframe job (the first call
    of each segment), run eagerly."""
    calls = {}

    def run(name, fn, static, **inputs):
        calls.setdefault(name, (fn, static, inputs))
        return call_segment(name, fn, static, **inputs)

    tracker.map_graphs.run = run
    try:
        tracker._mapping_compute(m, ki)
    finally:
        del tracker.map_graphs.run
    return calls


def _segment_inputs(snap) -> dict:
    """Every mapping segment's (fn, static, inputs) at the last job's
    state: the job's own (mapping_front's, the local BA's, the normals'),
    a compaction, and keyframe insertion as a monocular and a depth
    sensor's tracker run it (keyframe ki's row as the new keyframe)."""
    system, m, ki = _last_job(snap)
    tr = system.tracker
    calls = _record_job(tr, m, ki)
    calls["compact"] = (steps.compact_segment, {}, dict(m=steps.map_fields(m, steps.COMPACT_FIELDS)))
    feats = FrameFeatures(xy=m.kf_kp_xy[ki], level=m.kf_kp_level[ki], angle=m.kf_kp_angle[ki],
                          desc=m.kf_kp_desc[ki], valid=m.kf_kp_valid[ki], u_right=m.kf_kp_uright[ki],
                          depth=torch.full_like(m.kf_kp_angle[ki], 2.0))
    idx = torch.full((1,), int(m.n_kf) % m.capacity_kf)
    for depth in (False, True):
        fields = steps.KF_INSERT_FIELDS + (steps.POINT_FIELDS if depth else ())
        calls[f"kf_insert_{'depth' if depth else 'mono'}"] = (
            steps.kf_insert_segment, dict(cam=CAM, recycled=False, depth=depth, th_depth=3.0),
            dict(m=steps.map_fields(m, fields), feats=feats, R=m.kf_R[ki], t=m.kf_t[ki],
                 frame_id=torch.full((1,), 99, dtype=torch.int32), obs=torch.full_like(m.kf_obs_pt[ki], -1),
                 ki=idx, scale_factors=tr.scale_factors))
    return calls


SEGMENTS = sorted(FRONT_SEGMENTS) + ["local_ba", "normals", "compact", "kf_insert_mono", "kf_insert_depth"]


@pytest.fixture(scope="module")
def segment_inputs(snap):
    return _segment_inputs(snap)


@pytest.mark.parametrize("segment", SEGMENTS)
def test_mapping_segment_makes_no_host_read_or_copy(segment_inputs, segment, monkeypatch):
    """As test_torch_step_graphs.py's track segments: on meta tensors, with
    every host<->device copy refused. The camera's intrinsics are copied to
    the device once before (steps._intrinsics, cached per device), as a
    card's warm-up run before each capture does."""
    steps._intrinsics(CAM, torch.device("meta"))
    fn, static, inputs = segment_inputs[segment]
    _runs_on_meta(fn, static, inputs, monkeypatch)


def _keys(tracker, m, ki):
    """(the StepGraphs keys of one keyframe job, its list lengths)."""
    keys, counts = set(), []

    def run(name, fn, static, **inputs):
        leaves = []
        for k, v in inputs.items():
            _flatten(v, k, leaves)
        keys.add((name, tuple(sorted((k, repr(v)) for k, v in static.items())),
                  tuple((p, tuple(t.shape), t.dtype) for p, t in leaves)))
        out = call_segment(name, fn, static, **inputs)
        if name == "map_head":
            counts.append(tuple(int(x) for x in out[2]))
        return out

    tracker.map_graphs.run = run
    try:
        tracker._mapping_compute(m, ki)
    finally:
        del tracker.map_graphs.run
    return keys, counts[0]


def test_keyframe_jobs_share_their_keys(snap):
    """An early and the last keyframe job of the session: other keyframes,
    other neighbour and fuse-pair counts, the same keys (one graph each on
    a card)."""
    system, kept, _ = snap
    tr = system.tracker
    jobs = sorted(kept)
    (k1, c1), (k2, c2) = (_keys(tr, *kept[j]) for j in (jobs[1], jobs[-1]))
    assert kept[jobs[1]][1] != kept[jobs[-1]][1] and c1[0] != c2[0] and c1[1] != c2[1], (c1, c2)
    assert k1 == k2
    assert {k[0] for k in k1} == FRONT_SEGMENTS | {"local_ba", "normals"}


def test_session_mapped_through_graphs_equals_eager(snap):
    """The fixture's session (mapping through map_graphs, keyframe
    insertion through the tracker's graphs) against the same session with
    every mapping segment run eagerly: every pose and map tensor equal. On
    the CPU nothing replays: map_graph_replays stays 0."""
    system, kept, outs = snap
    eager, _, outs_e = _session(eager=True)
    a, b = system.tracker, eager.tracker
    assert a.map_graphs.runs > 0 and b.map_graphs.runs == 0
    assert a.stats["map_graph_replays"] == a.stats["map_graph_captures"] == 0
    assert a._n_kf_host == b._n_kf_host and len(kept) >= 4
    for x, y in zip(outs, outs_e):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
    _maps_equal(a.map, b.map)


def test_forced_compaction_through_graphs_equals_eager(snap):
    """A keyframe job whose map sits at the compaction trigger (the
    watermark at capacity): compact_segment through map_graphs equals it
    eager, and so does the old -> new remap the tracker keeps."""
    system, m, ki = _last_job(snap)
    tr = system.tracker
    full = m._replace(n_pt=torch.full((), m.capacity_pt, dtype=torch.int32))
    got = tr._mapping_compute(full, ki)
    remap = tr._pending_pt_remap
    tr.map_graphs.run = call_segment
    try:
        want = tr._mapping_compute(full, ki)
    finally:
        del tr.map_graphs.run
    _maps_equal(got, want)
    assert torch.equal(remap, tr._pending_pt_remap)
    assert int((remap >= 0).sum()) == int(m.pt_valid.sum())  # every valid point kept a slot
    assert int(got.n_pt) < m.capacity_pt
    tr._pending_pt_remap = None


def test_async_mapping_runs_map_graphs_on_the_mapping_thread():
    """With async_mapping each keyframe job's segments go through
    map_graphs on the mapping thread, and the tracking thread's graphs
    (its step, keyframe insertion) never run there."""
    system = System(CAM, device="cpu", async_mapping=True, **SESSION)
    tr = system.tracker
    seen = {"graphs": set(), "map_graphs": set()}
    for attr in seen:
        g = getattr(tr, attr)

        def run(name, fn, static, _run=g.run, _seen=seen[attr], **inputs):
            _seen.add((threading.current_thread().name, name))
            return _run(name, fn, static, **inputs)

        g.run = run
    mono_session(system, _frames()[:10])
    tr.export_trajectory()  # drains the mapping job
    system.shutdown()
    threads = {t for t, _ in seen["map_graphs"]}
    assert threads and all(t.startswith("local-mapping") for t in threads), threads
    assert FRONT_SEGMENTS <= {n for _, n in seen["map_graphs"]}
    assert not any(t.startswith("local-mapping") for t, _ in seen["graphs"])
    assert ("MainThread", "kf_insert") in seen["graphs"]


def test_a_copied_tracker_has_its_own_mapping_graphs(snap):
    """A deep copy (a pickle, as a mapping process ships its config and
    snapshots) of a tracker that has mapped gets fresh graphs: it captures
    its own and shares no static buffer with the original."""
    import copy

    tr = snap[0].tracker
    twin = copy.deepcopy(tr)
    for name in ("graphs", "map_graphs"):
        g, h = getattr(tr, name), getattr(twin, name)
        assert h is not g and h.runs == h.captures == 0 and not h._buffers
    assert twin.map_graphs.stage == "map.capture" and twin.graphs.stage == "track.capture"


def test_a_capture_tally_is_the_capturing_threads_own():
    """While one thread counts a capture's kernel launches apart
    (ops/launch_count.py), another thread's launches reach the counter,
    as a tracking thread's do while an async_mapping thread captures."""
    from tpuslam_torch.ops.launch_count import capture_tally, count_launch

    def kernel():
        pass

    kernel.launches = 0
    inside, done = threading.Event(), threading.Event()

    def other():
        inside.wait()
        count_launch(kernel)
        count_launch(kernel)
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with capture_tally() as tally:
        count_launch(kernel)
        inside.set()
        done.wait()
        count_launch(kernel)
    t.join()
    count_launch(kernel)
    assert tally == {"kernel": 2} and kernel.launches == 3


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_captures_in_two_threads_on_card():
    """Two threads capture into their own StepGraphs at once, each on its
    own stream, as the tracking thread and an async_mapping thread do in a
    session's first frames: the captures take turns (entering a capture
    synchronizes the device, which would invalidate the other's), and
    every replay equals its eager run. A child process: a failed capture
    may leave the CUDA context unusable."""
    import subprocess

    _cuda()
    code = (
        "import threading, torch\n"
        "from tpuslam_torch.pipeline.graphs import StepGraphs\n"
        "def seg(x):\n"
        "    for _ in range(200):\n"
        "        x = torch.sin(x) * 1.0001 + 0.5\n"
        "    return x\n"
        "errors, equal = [], []\n"
        "start = threading.Barrier(2)\n"
        "def work(k):\n"
        "    g, s = StepGraphs('cuda'), torch.cuda.Stream()\n"
        "    with torch.cuda.stream(s):\n"
        "        start.wait()\n"
        "        try:\n"
        "            for n in range(6):\n"
        "                x = torch.linspace(0, 1, 1000 + 100 * n + k, device='cuda')\n"
        "                equal.append(torch.equal(g.run('seg', seg, {}, x=x), seg(x)))\n"
        "        except Exception as e:\n"
        "            errors.append(repr(e))\n"
        "        s.synchronize()\n"
        "threads = [threading.Thread(target=work, args=(k,)) for k in range(2)]\n"
        "[t.start() for t in threads]\n"
        "[t.join() for t in threads]\n"
        "print('errors', errors, 'equal', sum(equal), 'of', len(equal))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=300)
    assert "errors [] equal 12 of 12" in out.stdout, out.stdout + out.stderr


@pytest.mark.cuda
def test_keyframe_job_graphed_equals_eager_on_card():
    """A keyframe job of the session on the card: graphed (captured at the
    first call, replayed at the second) equal to eager (torch.equal on
    every field); the replayed job counts in map_graph_replays and makes
    no more device->host reads than the eager one."""
    _cuda()
    system, kept, _ = _session("cuda")
    tr = system.tracker
    m, ki = kept[max(kept)]
    captures = tr.map_graphs.captures
    replayed = tr.stats["map_graph_replays"]
    first = tr._mapping_compute(m, ki)
    second = tr._mapping_compute(m, ki)
    assert tr.map_graphs.captures == captures  # the session captured every key
    assert tr.stats["map_graph_replays"] == replayed + 2
    tr.map_graphs.run = call_segment
    eager = tr._mapping_compute(m, ki)
    _maps_equal(first, eager)
    _maps_equal(second, eager)


@pytest.mark.cuda
def test_graphed_mapping_session_equals_eager_on_card():
    """The 14-frame mono session on the card, mapping through map_graphs
    and mapping eagerly: every pose and map tensor equal; every keyframe
    job that captured nothing replayed, and the mapping captures are few
    (one per key)."""
    _cuda()
    (a, kept, out_a), (b, _, out_b) = _session("cuda"), _session("cuda", eager=True)
    ta, tb = a.tracker, b.tracker
    jobs = len(kept)
    captured = len({c["segment"] for c in ta.map_graphs.captured})
    assert ta.stats["map_graph_captures"] == ta.map_graphs.captures == captured <= 8
    assert ta.stats["map_graph_replays"] >= jobs - 2 and tb.stats["map_graph_replays"] == 0
    for x, y in zip(out_a, out_b):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
    _maps_equal(ta.map, tb.map)
