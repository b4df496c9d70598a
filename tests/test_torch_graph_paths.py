"""The port's other compiled programs through StepGraphs (pipeline/graphs.py):
the batched tracking step, MultiTracker's batched front end,
relocalization, localization mode's visual odometry and the essential
graph's CG. On the CPU at small sizes, reusing test_torch_step_graphs.py's
session (320x240, 300 features, K=8, 600 keypoint slots, P=4096),
test_torch_multi.py's stereo streams (two paths at 320x240, 500 features)
and test_torch_pose_graph.py's drifted loop (testing.drifted_loop); and on
a card.

For each path:
- the StepGraphs route (static buffers on the CPU, graph replays on a card)
  equals the eager route (every segment through call_segment) bit for bit;
- the eager route, through the same segments, still matches the JAX
  package's function on the same inputs, within the tolerance of the
  existing test of that function (stated at each comparison);
- each new segment runs on meta tensors with no device->host read, no copy
  between the host and the device, and no input modified.
Relocalization runs EPnP's eigh and SVD eagerly between its segments:
cuSOLVER's calls check their status on the host, which a capture refuses
(the `cuda` test holds a segment with an eigh to a raised capture).

This module imports no jax at its top (the JAX comparisons import it), so
its card tests run on a machine without it:
    python -m pytest --noconftest tests/test_torch_graph_paths.py -m cuda
"""

import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from tpuslam_torch.convert import array_to_tensor, frame_features_to_numpy, map_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig, extract_orb_batched
from tpuslam_torch.optim import pose_graph
from tpuslam_torch.pipeline import steps
from tpuslam_torch.pipeline.graphs import StepGraphs, call_segment
from tpuslam_torch.pipeline.multi import MultiTracker
from tpuslam_torch.pipeline.track_step import track_step_batched, track_step_segment
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig, TrackingState
from tpuslam_torch.sfm import pnp
from tpuslam_torch.testing import (
    TRACK_STEP_ARGS,
    StepWallScene,
    coherent_track_inputs,
    depth_at,
    drifted_loop,
    orbit_trajectory,
    render_stereo_frames,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_step_graphs import (  # noqa: E402  (its session fixture and meta-tensor helpers)
    CAM,
    CFG,
    K,
    P,
    SNAP,
    _host_data_refused,
    _NoHostTraffic,
    _on,
    session,  # noqa: F401
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
# __graft_entry__.entry_batched's step (bench.py's), at its own size.
STEP_CAM = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, width=640, height=480)
STEP_CFG = ORBConfig(n_features=1000)
# test_torch_multi.py's stereo streams, 4 frames.
MULTI_CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=42.0, width=320, height=240)
MULTI_KW = dict(max_keyframes=24, max_points=6000, kf_max_frames=8, enable_loop_closing=False)
MULTI_ORB = ORBConfig(n_features=500)
MULTI_FRAMES = 4


# ----------------------------------------------------------------- helpers

def _equal(a, b):
    """Trees of tensors (tuples, NamedTuples, None) equal bit for bit."""
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, tuple):
        return isinstance(b, tuple) and len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    return a == b


def _both_ways(fn):
    """fn(run) through a fresh StepGraphs on the CPU and through
    call_segment; returns (graphed, eager, names of the segments run)."""
    graphs, names = StepGraphs("cpu"), []

    def run(name, f, static, **inputs):
        names.append(name)
        return graphs.run(name, f, static, **inputs)

    return fn(run), fn(call_segment), names


def _runs_on_meta(fn, static, inputs, monkeypatch, kernels: bool = False):
    """fn(**inputs, **static) on meta tensors with host traffic refused
    (test_torch_step_graphs.py's rules); returns its outputs' leaves. With
    `kernels`, the two kernels' wrappers (which take CPU or CUDA tensors)
    give meta outputs of their shapes: a launch reads nothing back, and the
    card's captures of the same segments hold the kernels to that; and a
    warm-up call runs first, unchecked, as StepGraphs warms a segment up
    before its capture (the extraction's per-device constant tables are
    copied to the device once, there)."""
    if kernels:
        from tpuslam_torch.ops import orb, stereo
        from tpuslam_torch.ops.patches import PSIZE

        def fast(levels, min_th):
            return [torch.empty_like(x) for x in levels]

        def gather(atlas, corner):
            return torch.empty((corner.shape[0], PSIZE, PSIZE), device=atlas.device)

        monkeypatch.setattr(orb, "fast_nms_pyramid", fast)
        monkeypatch.setattr(orb, "gather_patches", gather)
        monkeypatch.setattr(stereo, "gather_patches", gather)
    monkeypatch.setattr(torch, "tensor", _host_data_refused(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", _host_data_refused(torch.as_tensor))
    meta = {k: _on(v, lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"))
            for k, v in inputs.items()}
    leaves = []
    for v in meta.values():
        _on(v, lambda t: leaves.append(t) or t)
    versions = [t._version for t in leaves]
    if kernels:
        fn(**meta, **static)
    with _NoHostTraffic():
        out = fn(**meta, **static)
    got = []
    _on(out if isinstance(out, tuple) else (out,), lambda t: got.append(t) or t)
    assert got and all(o.device.type == "meta" for o in got)
    assert [t._version for t in leaves] == versions  # no input modified
    return got


def _tracker(st, device="cpu"):
    """A Tracker of the session's capacities holding its map, LOST."""
    tr = Tracker(TrackerConfig(cam=CAM, orb=CFG, max_keyframes=K, max_points=P,
                               enable_loop_closing=False), device=device)
    tr.map, tr._last_kf_idx, tr.state = st.m, st.ref_kf, TrackingState.LOST
    tr._last_R, tr._last_t = st.last_R, st.last_t
    return tr


def _jax():
    import jax
    import jax.numpy as jnp

    from tpuslam.geometry.camera import PinholeCamera as JCamera
    from tpuslam.mapstate import core as jcore

    return types.SimpleNamespace(
        jax=jax, jnp=jnp, cam=JCamera(**CAM._asdict()),
        map=lambda m: jcore.MapState(*(jnp.asarray(x) for x in map_to_numpy(m))),
        feats=lambda f: jcore.FrameFeatures(*(jnp.asarray(x) for x in frame_features_to_numpy(f))),
        a=lambda x: jnp.asarray(x.numpy()))


@pytest.fixture(scope="module")
def depth_frames(session):
    """The snapshot frame's and the last frame's features with the rendered
    depth at each keypoint (localization mode's VO points need depth)."""
    s, st, feats = session
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(SNAP + 1, step=0.02, x0=-0.5, yaw_rate=0.002)

    def with_depth(f, i):
        _, z = scene.render(CAM, *poses[i], with_depth=True)
        return f._replace(depth=depth_at(torch.from_numpy(np.asarray(z, np.float32)), f.xy))

    return with_depth(feats, SNAP), with_depth(st.last_feats, SNAP - 1)


# ------------------------------------------------- 1. the batched step

@pytest.fixture(scope="module")
def step_inputs():
    """test_torch_track_step.py's coherent inputs: one stream, 1000 points."""
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(2, step=0.04)
    return coherent_track_inputs(scene, STEP_CAM, STEP_CFG, [(poses[0], poses[1])], 1000,
                                 np.random.default_rng(1))


def test_batched_step_graphed_equals_eager_and_matches_jax(step_inputs):
    """Tolerance of test_torch_track_step.py (the JAX step under jit, whose
    fused multiply-adds move keypoints): n_valid equal, R and t within
    1e-3, n_inl2 within 2%."""
    import jax
    import jax.numpy as jnp

    import __graft_entry__

    args = [array_to_tensor(step_inputs[k], "cpu") for k in TRACK_STEP_ARGS]
    graphed, eager, names = _both_ways(lambda run: track_step_batched(STEP_CAM, STEP_CFG, *args, run=run))
    assert names == ["batched"] and _equal(graphed, eager)
    step, _ = __graft_entry__.entry_batched(1, 1000)
    jR, jt, jn, jv = (np.asarray(x) for x in jax.jit(step)(*[jnp.asarray(step_inputs[k])
                                                            for k in TRACK_STEP_ARGS]))
    R, t, n, nv = eager
    assert int(nv) == int(jv)
    np.testing.assert_allclose(R.numpy(), jR, rtol=0, atol=1e-3)
    np.testing.assert_allclose(t.numpy(), jt, rtol=0, atol=1e-3)
    assert abs(int(n[0]) - int(jn[0])) <= 0.02 * int(jn[0])


def test_batched_step_segment_makes_no_host_read_or_copy(monkeypatch):
    """At the session's camera and ORB settings, B=2 streams, 300 last-frame
    points and 512 local-map points (only the shapes reach a meta run)."""
    B, N, L = 2, 300, 512
    f, i = torch.float32, torch.int32
    shapes = dict(imgs=((B, CAM.height, CAM.width), f), last_xyz=((B, N, 3), f),
                  last_desc=((B, N, 8), i), last_level=((B, N), i), last_angle=((B, N), f),
                  map_xyz=((B, L, 3), f), map_desc=((B, L, 8), i), map_normal=((B, L, 3), f),
                  map_min_d=((B, L), f), map_max_d=((B, L), f), R0=((B, 3, 3), f), t0=((B, 3), f),
                  inv_sigma2=((CFG.n_levels,), f))
    args = {k: torch.zeros(shape, dtype=dtype) for k, (shape, dtype) in shapes.items()}
    _runs_on_meta(track_step_segment, dict(cam=CAM, cfg=CFG), args, monkeypatch, kernels=True)


# ------------------------------------------- 2. MultiTracker's front end

@pytest.fixture(scope="module")
def stereo_streams():
    scene = StepWallScene(np.random.default_rng(5))
    paths = [orbit_trajectory(MULTI_FRAMES, step=0.045),
             orbit_trajectory(MULTI_FRAMES, step=0.04, yaw_rate=-0.003, x0=-0.3)]
    return [render_stereo_frames(scene, MULTI_CAM, p) for p in paths]


def _multi(graphed: bool) -> MultiTracker:
    mt = MultiTracker.uniform(TrackerConfig(cam=MULTI_CAM, orb=MULTI_ORB, **MULTI_KW), 2, device="cpu")
    if not graphed:
        mt.graphs.run = call_segment
        for tr in mt.trackers:
            tr.graphs.run = call_segment
    return mt


def _pair_batch(frames, i):
    return torch.cat([torch.stack([f[i][0] for f in frames]), torch.stack([f[i][1] for f in frames])])


def test_multitracker_stereo_graphed_equals_eager(stereo_streams):
    """Both streams over every frame, the front end and each stream's step
    through the graphs against every segment eager: the same poses, the
    same maps."""
    runs = []
    for graphed in (True, False):
        mt = _multi(graphed)
        outs = [mt.track_stereo(torch.stack([f[i][0] for f in stereo_streams]),
                                torch.stack([f[i][1] for f in stereo_streams]), i)
                for i in range(MULTI_FRAMES)]
        runs.append((mt, outs))
    (a, out_a), (b, out_b) = runs
    assert all(o is not None for out in out_a for o in out)
    for x, y in zip(out_a, out_b):
        for p, q in zip(x, y):
            assert np.array_equal(p[0], q[0]) and np.array_equal(p[1], q[1])
    for ta, tb in zip(a.trackers, b.trackers):
        assert ta._n_kf_host == tb._n_kf_host
        for name, x in ta.map._asdict().items():
            assert torch.equal(x, getattr(tb.map, name)), name


def test_multitracker_front_segments_match_jax(stereo_streams):
    """The stereo segment against the JAX MultiTracker's jitted extraction
    and per-stream stereo post-processing, within
    test_torch_stereo.py::test_stereo_frame_features_matches_jitted_jax's
    tolerance (>= 99% of keypoints equal, the stereo verdict on >= 97% of
    them, u_right within 0.05 px at the 99th percentile); the mono segment
    equal to each stream's extraction from the batch and undistortion (the
    eager route before the segment) and to the JAX extraction's keypoints
    within the same tolerance."""
    from tpuslam.geometry.camera import PinholeCamera as JCamera
    from tpuslam.ops.orb import ORBConfig as JORBConfig
    from tpuslam.ops.orb import ORBFeatures as JORBFeatures
    from tpuslam.pipeline.multi import MultiTracker as JMultiTracker
    from tpuslam.pipeline.tracker import TrackerConfig as JTrackerConfig

    j = _jax()
    imgs = _pair_batch(stereo_streams, 1)
    cams = (MULTI_CAM, MULTI_CAM)
    graphed, eager, _ = _both_ways(lambda run: run(
        "front", steps.batched_stereo_features, dict(orb=MULTI_ORB, cams=cams), imgs=imgs))
    assert _equal(graphed, eager)
    jmt = JMultiTracker.uniform(JTrackerConfig(cam=JCamera(**MULTI_CAM._asdict()),
                                               orb=JORBConfig(n_features=500), **MULTI_KW), 2)
    fb_j = jmt._extract_batched(j.a(imgs))
    for b, got in enumerate(eager):
        fL = JORBFeatures(*(leaf[b] for leaf in fb_j))
        fR = JORBFeatures(*(leaf[2 + b] for leaf in fb_j))
        ref = jmt._stereo_post(fL, fR, j.a(imgs[b]), j.a(imgs[2 + b]), j.jnp.float32(MULTI_CAM.fx),
                               j.jnp.float32(MULTI_CAM.bf))
        same_kp = ((np.abs(got.xy.numpy() - np.asarray(ref.xy)) < 1e-3).all(-1)
                   & (got.level.numpy() == np.asarray(ref.level))
                   & (got.valid.numpy() == np.asarray(ref.valid)))
        assert same_kp.mean() >= 0.99, same_kp.mean()
        both = same_kp & got.valid.numpy()
        gv, jv = got.u_right.numpy() >= 0, np.asarray(ref.u_right) >= 0
        assert (gv == jv)[both].mean() >= 0.97, (gv == jv)[both].mean()
        m = both & gv & jv
        du = np.abs(got.u_right.numpy() - np.asarray(ref.u_right))[m]
        assert m.sum() > 100 and np.quantile(du, 0.99) < 0.05, np.quantile(du, 0.99)

    # Mono: streams 0 and 2 of the same 4-image batch (the JAX extraction
    # above serves).
    graphed, eager, _ = _both_ways(lambda run: run(
        "front", steps.batched_mono_features, dict(orb=MULTI_ORB, streams=(0, 2), cams=cams), imgs=imgs))
    assert _equal(graphed, eager)
    fb = extract_orb_batched(imgs, MULTI_ORB)
    for b, got in zip((0, 2), eager):
        one = steps.mono_features(MULTI_CAM, type(fb)(*(leaf[b] for leaf in fb)))
        assert _equal(got, one)
        ref = jmt._features_from_batch(fb_j, b, jmt.trackers[0])
        same_kp = ((np.abs(got.xy.numpy() - np.asarray(ref.xy)) < 1e-3).all(-1)
                   & (got.level.numpy() == np.asarray(ref.level))
                   & (got.valid.numpy() == np.asarray(ref.valid)))
        assert same_kp.mean() >= 0.99, same_kp.mean()


@pytest.mark.parametrize("sensor", ["stereo", "mono"])
def test_multitracker_front_segment_makes_no_host_read_or_copy(stereo_streams, sensor, monkeypatch):
    imgs = _pair_batch(stereo_streams, 0)
    if sensor == "stereo":
        fn, static = steps.batched_stereo_features, dict(orb=MULTI_ORB, cams=(MULTI_CAM, MULTI_CAM))
    else:
        fn, static = steps.batched_mono_features, dict(orb=MULTI_ORB, streams=(1,), cams=(MULTI_CAM,))
        imgs = imgs[:2]
    _runs_on_meta(fn, static, dict(imgs=imgs), monkeypatch, kernels=True)


# ---------------------------------------------------- 3. relocalization

@pytest.mark.parametrize("branch", ["bow", "brute_force"])
def test_relocalization_graphed_equals_eager(session, branch):
    """Tracker._relocalize from the session's map with its segments through
    the tracker's graphs, and again with every segment eager: the same
    verdict, pose and assignment, through the same segments. The BoW
    branch gets the reference keyframe and keyframe 0 as candidates."""
    s, st, feats = session
    runs = []
    for graphed in (True, False):
        tr = _tracker(st)
        names = []
        inner = tr.graphs.run if graphed else call_segment

        def run(name, fn, static, inner=inner, names=names, **inputs):
            names.append(name)
            return inner(name, fn, static, **inputs)

        tr.graphs.run = run
        if branch == "bow":
            tr._reloc_candidate_kfs = lambda f: [st.ref_kf, 0]
        ok = tr._relocalize(feats, 99)
        runs.append((ok, tr.reloc_path, names, tr._last_R, tr._last_t, tr._last_obs))
    (ok, path, names, *got), (ok_e, path_e, names_e, *ref) = runs
    assert ok and ok_e and path == path_e == branch and names == names_e
    assert {"pnp_hypotheses", "pnp_system", "pnp_cross", "pnp_select", "pnp_system_refit",
            "pnp_cross_refit", "pnp_finish", "pose", "polish"} <= set(names)
    assert ("reloc_match" in names) == (branch == "bow")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_reloc_widening_graphed_equals_eager(session):
    """_reloc_widen from a starved assignment (the first 20 matches against
    the reference keyframe): both windows run, graphed equal to eager."""
    s, st, feats = session
    runs = []
    for graphed in (True, False):
        tr = _tracker(st)
        if not graphed:
            tr.graphs.run = call_segment
        pt_idx, ok = tr._match_frame_to_kf_points(feats, st.ref_kf)
        keep = torch.nonzero(ok & (pt_idx >= 0))[:20, 0]
        obs = torch.full_like(pt_idx, -1)
        obs[keep] = pt_idx[keep]
        R, t = st.m.kf_R[st.ref_kf], st.m.kf_t[st.ref_kf]
        runs.append(tr._reloc_widen(feats, st.ref_kf, R, t, obs, 20))
    (R, t, obs, n), (Re, te, obse, ne) = runs
    assert n == ne >= 30 and torch.equal(R, Re) and torch.equal(t, te) and torch.equal(obs, obse)


def test_relocalization_segments_match_jax(session):
    """Each relocalization segment through StepGraphs' buffers against the
    JAX function on the same inputs: the keyframe match and the projective
    widening exact (test_torch_mapping.py's); EPnP RANSAC within
    test_torch_sfm.py's tolerance (R 3e-3, t 1e-2, >= 98% of inlier flags,
    the count within 2; the JAX key's picks replayed); the pose
    optimization and the TrackLocalMap polish within
    test_torch_step_graphs.py's (poses 1e-3, integers and masks exact)."""
    from tpuslam.pipeline import steps as jsteps
    from tpuslam.pipeline.tracker import Tracker as JTracker
    from tpuslam.sfm.pnp import pnp_ransac as jpnp

    j = _jax()
    s, st, feats = session
    tr = _tracker(st)
    jm, jf = j.map(st.m), j.feats(feats)
    kf = st.ref_kf

    pt_idx, ok = tr._match_frame_to_kf_points(feats, kf)
    jpt, jok = JTracker._match_frame_to_kf_points(types.SimpleNamespace(map=jm), jf, kf)
    np.testing.assert_array_equal(pt_idx.numpy(), np.asarray(jpt))
    np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))

    # EPnP RANSAC on test_torch_sfm.py's problem (100 points at 0.5 px of
    # noise, 30 outliers), the graphed route against the eager one and JAX.
    from tpuslam.geometry import project as jproject, se3_apply as jse3_apply, se3_exp as jse3_exp
    from tpuslam.geometry.camera import PinholeCamera as JCamera

    sfm_cam = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    jcam = JCamera(**sfm_cam._asdict())
    rng = np.random.default_rng(0)
    X = np.stack([rng.uniform(-3, 3, 100), rng.uniform(-2, 2, 100), rng.uniform(4, 10, 100)],
                 -1).astype(np.float32)
    jRg, jtg = jse3_exp(j.jnp.asarray([0.1, 0.2, -0.1, 0.3, 0.1, -0.2], j.jnp.float32))
    uv = np.array(jproject(jcam, jse3_apply(jRg, jtg, j.jnp.asarray(X))))
    uv += rng.normal(size=uv.shape).astype(np.float32) * 0.5
    uv[rng.choice(100, 30, replace=False)] += rng.uniform(25, 100, size=(30, 2)).astype(np.float32)
    inv_s2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], 100).astype(np.float32)
    valid = np.ones(100, bool)
    key = j.jax.random.PRNGKey(1)
    picks = torch.from_numpy(np.array(j.jax.random.randint(key, (128, 4), 0, 100)))
    args = (steps._intrinsics(sfm_cam, torch.device("cpu"))[0], torch.from_numpy(X), torch.from_numpy(uv),
            torch.from_numpy(inv_s2), torch.from_numpy(valid))
    r, r_eager, names = _both_ways(lambda run: pnp.pnp_ransac(*args, picks=picks, run=run))
    assert _equal(r, r_eager) and names == ["pnp_hypotheses", "pnp_system", "pnp_cross", "pnp_select",
                                            "pnp_system_refit", "pnp_cross_refit", "pnp_finish"]
    jr = jpnp(key, jcam.K, *(j.jnp.asarray(x) for x in (X, uv, inv_s2, valid)))
    assert bool(r.success) and bool(jr.success)
    np.testing.assert_allclose(r.R.numpy(), np.asarray(jr.R), atol=3e-3)
    np.testing.assert_allclose(r.t.numpy(), np.asarray(jr.t), atol=1e-2)
    assert (r.inliers.numpy() == np.asarray(jr.inliers)).mean() >= 0.98
    assert abs(int(r.n_inliers) - int(jr.n_inliers)) <= 2

    # The pose optimization from the keyframe match, at the reference
    # keyframe's pose.
    obs = torch.where(ok & (pt_idx >= 0), pt_idx, -1)
    r = types.SimpleNamespace(R=st.m.kf_R[kf], t=st.m.kf_t[kf])
    R, t, obs2, n = tr._optimize_pose(feats, obs, r.R, r.t)
    jR, jt, jobs, jn = jsteps.optimize_frame_pose(j.cam, jm, jf, j.a(obs), j.a(r.R), j.a(r.t),
                                                  j.a(tr.inv_sigma2))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(obs2.numpy(), np.asarray(jobs))
    assert int(n) == int(jn)

    starved = torch.where(torch.arange(obs2.shape[0]) < 40, obs2, -1)
    got, n_add = tr.graphs.run(
        "reloc_search", steps.reloc_search_by_projection,
        dict(cam=CAM, scale_factor=CFG.scale_factor, n_levels=CFG.n_levels, window=10.0,
             max_desc_dist=100),
        m=steps.map_fields(st.m, steps.RELOC_SEARCH_FIELDS), kf=tr._index(kf), R=R, t=t, cur=feats,
        obs_pt=starved)
    with j.jax.disable_jit():
        jgot, jn_add = jsteps.reloc_search_by_projection(
            j.cam, jm, j.jnp.int32(kf), j.a(R), j.a(t), jf, j.a(starved), scale_factor=CFG.scale_factor,
            n_levels=CFG.n_levels, window=10.0, max_desc_dist=100)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jgot))
    assert int(n_add) == int(jn_add) > 0

    R3, t3, obs3, n3, vis, found = tr._track_local_map(st.m, R, t, feats, obs2)
    jR3, jt3, jobs3, jn3, jvis, jfound = jsteps.track_local_map(
        j.cam, jm, j.a(R), j.a(t), jf, j.a(obs2), j.a(tr.inv_sigma2),
        scale_factor=CFG.scale_factor, n_levels=CFG.n_levels)
    np.testing.assert_allclose(R3.numpy(), np.asarray(jR3), rtol=0, atol=1e-3)
    np.testing.assert_allclose(t3.numpy(), np.asarray(jt3), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(obs3.numpy(), np.asarray(jobs3))
    np.testing.assert_array_equal(vis.numpy(), np.asarray(jvis))
    np.testing.assert_array_equal(found.numpy(), np.asarray(jfound))
    assert int(n3) == int(jn3)


def _reloc_segment_inputs(s, st, feats):
    """Each relocalization segment's (fn, static, inputs) at the session's
    state, with inputs of the shapes relocalization gives them."""
    n = feats.xy.shape[0]
    kf = torch.full((1,), st.ref_kf, dtype=torch.int64)
    obs = st.last_obs
    w = torch.rand(128, n)
    K3 = steps._intrinsics(CAM, torch.device("cpu"))[0]
    pnp_args = dict(K=K3, pts_w=st.m.pt_xyz[:n], uv=feats.xy, inv_sigma2=torch.ones(n), valid=feats.valid)
    kabsch = dict(U=torch.eye(3).repeat(128, 1, 1), Vh=torch.eye(3).repeat(128, 1, 1),
                  cw=torch.zeros(128, 3), cc=torch.zeros(128, 3))
    one = {k: v[0] for k, v in kabsch.items()}
    return {
        "reloc_match": (steps.reloc_match_segment, {}, dict(
            m=steps.map_fields(st.m, steps.RELOC_MATCH_FIELDS), kf=kf, feats=feats)),
        "pnp_hypotheses": (pnp._pnp_hypotheses, {}, dict(
            pts_w=st.m.pt_xyz[:n], valid=feats.valid, picks=torch.zeros(128, 4, dtype=torch.int64))),
        "pnp_system": (pnp._epnp_system, {}, dict(
            Pw=st.m.pt_xyz[:n], uv=feats.xy, w=w, c0=torch.zeros(128, 3), eigval=torch.ones(128, 3),
            eigvec=torch.eye(3).repeat(128, 1, 1), K=K3)),
        "pnp_cross": (pnp._epnp_cross, {}, dict(
            Pw=st.m.pt_xyz[:n], w=w, ctrl_w=torch.zeros(128, 4, 3), alphas=torch.zeros(128, n, 4),
            vecs=torch.eye(12).repeat(128, 1, 1))),
        "pnp_select": (pnp._pnp_select, dict(chi2_th=5.991), dict(**pnp_args, **kabsch)),
        "pnp_finish": (pnp._pnp_finish, dict(chi2_th=5.991, min_inliers=15), dict(
            **pnp_args, **one, Rb=torch.eye(3), tb=torch.zeros(3), inl=feats.valid)),
        "pose": (steps.optimize_frame_pose, dict(cam=CAM), dict(
            m=steps.map_fields(st.m, steps.POSE_MAP_FIELDS), cur=feats, obs_pt=obs, R0=st.last_R,
            t0=st.last_t, inv_sigma2_table=s.inv_sigma2)),
        "reloc_search": (steps.reloc_search_by_projection, dict(
            cam=CAM, scale_factor=CFG.scale_factor, n_levels=CFG.n_levels, window=3.0, max_desc_dist=64),
            dict(m=steps.map_fields(st.m, steps.RELOC_SEARCH_FIELDS), kf=kf, R=st.last_R, t=st.last_t,
                 cur=feats, obs_pt=obs)),
        "polish": (steps.polish_segment, dict(
            cam=CAM, scale_factor=CFG.scale_factor, n_levels=CFG.n_levels, max_local_pts=256,
            cand_cap=128), dict(
            m=steps.map_fields(st.m, steps.POLISH_MAP_FIELDS), ref_kf=kf, feats=feats, R=st.last_R,
            t=st.last_t, obs=obs, inv_sigma2_table=s.inv_sigma2)),
    }


@pytest.mark.parametrize("segment", ["reloc_match", "pnp_hypotheses", "pnp_system", "pnp_cross",
                                     "pnp_select", "pnp_finish", "pose", "reloc_search", "polish"])
def test_relocalization_segment_makes_no_host_read_or_copy(session, segment, monkeypatch):
    """The polish runs the large-map regime (the local subset and the
    candidate block)."""
    fn, static, inputs = _reloc_segment_inputs(*session)[segment]
    _runs_on_meta(fn, static, inputs, monkeypatch)


# ------------------------------------------- 4. localization-mode VO

def _loc_tracker(st, feats_d, last_d, case, device="cpu"):
    """A tracker in localization mode at the session's state, its last
    frame's VO points made; `case`: "motion_model" (with the velocity),
    "reference" (none) or "mbvo" (the last frame tracked mostly VO points:
    the motion model and the brute-force relocalization)."""
    tr = _tracker(st, device)
    tr.localization_mode, tr._depth_mode, tr.state = True, True, TrackingState.OK
    tr._last_feats, tr._last_obs = last_d, st.last_obs
    tr._velocity = None if case == "reference" else (st.vel_R, st.vel_t)
    tr._vo_mode = case == "mbvo"
    tag = torch.where(st.last_obs >= 0, st.last_obs, -2)
    tr._vo_xyz, tr._vo_valid = steps.vo_points_segment(
        CAM, last_d, tag, torch.zeros(tag.shape[0], 3, device=device), st.last_R, st.last_t,
        th_depth=tr._th_depth)
    return tr


@pytest.mark.parametrize("case", ["motion_model", "reference", "mbvo"])
def test_localization_vo_graphed_equals_eager(session, depth_frames, case):
    s, st, _ = session
    feats_d, last_d = depth_frames
    runs = []
    for graphed in (True, False):
        tr = _loc_tracker(st, feats_d, last_d, case)
        names = []
        inner = tr.graphs.run if graphed else call_segment

        def run(name, fn, static, inner=inner, names=names, **inputs):
            names.append(name)
            return inner(name, fn, static, **inputs)

        tr.graphs.run = run
        ok = tr._track_frame_localization(feats_d, SNAP)
        runs.append((ok, names, tr._vo_mode, tr._last_R, tr._last_t, tr._last_obs, tr._vo_xyz,
                     tr._vo_valid, tr.map.pt_visible, tr.map.pt_found))
    (ok, names, vo, *got), (ok_e, names_e, vo_e, *ref) = runs
    assert ok and ok_e and names == names_e and vo == vo_e
    assert names[-1] == "vo_points"
    assert ("vo_mm" in names) == (case != "reference") and ("ref" in names) == (case == "reference")
    assert ("pnp_finish" in names) == (case == "mbvo")
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def test_localization_vo_segments_match_jax(session, depth_frames):
    """The VO motion model against the JAX track_motion_model_pts on the
    same last-frame table (map points, then VO points), within
    test_torch_step_graphs.py's tolerance (poses 1e-3, integers and masks
    exact); the next VO points against the JAX tracker's
    _update_vo_points (the selection exact, positions within 1e-5)."""
    from tpuslam.pipeline import steps as jsteps
    from tpuslam.pipeline.tracker import Tracker as JTracker

    j = _jax()
    s, st, _ = session
    feats_d, last_d = depth_frames
    tr = _loc_tracker(st, feats_d, last_d, "motion_model")
    out = tr.graphs.run(
        "vo_mm", steps.vo_motion_segment, dict(cam=CAM, th=7.0, scale_factor=CFG.scale_factor,
                                               n_levels=CFG.n_levels),
        m=steps.map_fields(st.m, steps.MM_MAP_FIELDS), last_feats=last_d, last_obs=st.last_obs,
        vo_xyz=tr._vo_xyz, vo_valid=tr._vo_valid, last_R=st.last_R, last_t=st.last_t,
        vel_R=st.vel_R, vel_t=st.vel_t, feats=feats_d, inv_sigma2_table=tr.inv_sigma2)
    m = st.m
    has_map = (st.last_obs >= 0) & last_d.valid & m.pt_valid[st.last_obs.clamp(min=0).long()]
    vo = tr._vo_valid & ~has_map & last_d.valid
    assert int(vo.sum()) > 0
    xyz = torch.where(vo[:, None], tr._vo_xyz, m.pt_xyz[st.last_obs.clamp(min=0).long()])
    R_pred, t_pred = st.vel_R @ st.last_R, st.vel_R @ st.last_t + st.vel_t
    ref = jsteps.track_motion_model_pts(
        j.cam, j.feats(last_d), j.a(xyz), j.a(torch.where(has_map, st.last_obs, -1)), j.a(has_map | vo),
        j.a(R_pred), j.a(t_pred), j.feats(feats_d), j.a(tr.inv_sigma2), scale_factor=CFG.scale_factor,
        n_levels=CFG.n_levels, th=7.0)
    R, t, tag, cxyz, n_map, n_tot, n_m = out
    jR, jt, jtag, jxyz, jn_map, jn_tot, jn_m = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(R.numpy(), jR, rtol=0, atol=1e-3)
    np.testing.assert_allclose(t.numpy(), jt, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(tag.numpy(), jtag)
    assert (int(n_map), int(n_tot), int(n_m)) == (int(jn_map), int(jn_tot), int(jn_m))
    np.testing.assert_allclose(cxyz.numpy(), jxyz, rtol=0, atol=1e-5)

    vo_xyz, vo_valid = tr.graphs.run("vo_points", steps.vo_points_segment,
                                     dict(cam=CAM, th_depth=float(tr._th_depth)), feats=feats_d,
                                     cur_tag=tag, cur_xyz=cxyz, R=R, t=t)
    fake = types.SimpleNamespace(cfg=types.SimpleNamespace(cam=j.cam), _th_depth=tr._th_depth)
    JTracker._update_vo_points(fake, j.feats(feats_d), j.a(tag), j.a(cxyz), j.a(R), j.a(t))
    np.testing.assert_array_equal(vo_valid.numpy(), np.asarray(fake._vo_valid))
    np.testing.assert_allclose(vo_xyz.numpy(), np.asarray(fake._vo_xyz), rtol=0, atol=1e-5)


@pytest.mark.parametrize("segment", ["vo_mm", "vo_mm_first", "vo_points"])
def test_localization_vo_segment_makes_no_host_read_or_copy(session, depth_frames, segment,
                                                           monkeypatch):
    """vo_mm_first: the first localization frame, before any VO point."""
    s, st, _ = session
    feats_d, last_d = depth_frames
    tr = _loc_tracker(st, feats_d, last_d, "motion_model")
    if segment == "vo_points":
        fn, static = steps.vo_points_segment, dict(cam=CAM, th_depth=1.5)
        inputs = dict(feats=feats_d, cur_tag=st.last_obs, cur_xyz=tr._vo_xyz, R=st.last_R, t=st.last_t)
    else:
        first = segment == "vo_mm_first"
        fn, static = steps.vo_motion_segment, dict(cam=CAM, th=14.0, scale_factor=CFG.scale_factor,
                                                   n_levels=CFG.n_levels)
        inputs = dict(m=steps.map_fields(st.m, steps.MM_MAP_FIELDS), last_feats=last_d,
                      last_obs=st.last_obs, vo_xyz=None if first else tr._vo_xyz,
                      vo_valid=None if first else tr._vo_valid, last_R=st.last_R, last_t=st.last_t,
                      vel_R=st.vel_R, vel_t=st.vel_t, feats=feats_d, inv_sigma2_table=tr.inv_sigma2)
    _runs_on_meta(fn, static, inputs, monkeypatch)


# --------------------------------------------- 5. the essential graph's CG

@pytest.mark.parametrize("fix_scale", [False, True])
def test_pose_graph_cg_graphed_equals_eager_and_matches_jax(fix_scale):
    """test_torch_pose_graph.py::test_matches_jax's CG case: its own
    StepGraphs (run=None) against every block eager, bit for bit with the
    same reads and CG iterations; and against the JAX CG within that
    test's tolerance (s, R 1e-3, t 1e-3 of its scale, the error history
    1e-3 relative)."""
    from tpuslam.optim.pose_graph import Sim3Edges as JSim3Edges
    from tpuslam.optim.pose_graph import optimize_pose_graph as joptimize

    j = _jax()
    Kn = 40
    s0, R0, t0, e = drifted_loop(Kn, loop_pairs=((None, 0), (Kn // 2, 0)))
    s0 = s0 * torch.linspace(1.0, 1.05, Kn) if not fix_scale else s0
    fixed = torch.zeros(Kn, dtype=torch.bool)
    fixed[0] = True
    valid = torch.ones(Kn, dtype=torch.bool)
    valid[3] = False
    stats = {"graphed": {}, "eager": {}}
    names = []
    real_run = StepGraphs.run

    def counting(self, name, fn, static, **inputs):
        names.append(name)
        return real_run(self, name, fn, static, **inputs)

    StepGraphs.run = counting
    try:
        graphed = pose_graph.optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=8, fix_scale=fix_scale,
                                                 dense_max_nodes=4, stats=stats["graphed"])
    finally:
        StepGraphs.run = real_run
    eager = pose_graph.optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=8, fix_scale=fix_scale,
                                           dense_max_nodes=4, stats=stats["eager"], run=call_segment)
    assert names and set(names) == {"pg_setup", "cg", "pg_update"}
    assert _equal(graphed, eager)
    g, ee = stats["graphed"], stats["eager"]
    assert g["reads"] == ee["reads"] and [int(x) for x in g["cg_iters"]] == [int(x) for x in ee["cg_iters"]]
    js, jR, jt, jerr = joptimize(*(j.a(x) for x in (s0, R0, t0, valid, fixed)),
                                 JSim3Edges(*(j.a(x) for x in e)), iters=8, fix_scale=fix_scale,
                                 dense_max_nodes=4)
    s, R, t, err = graphed
    tol = 1e-3
    scale = float(np.abs(np.asarray(jt)).max())
    np.testing.assert_allclose(s.numpy(), np.asarray(js), atol=tol)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=tol)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=tol * scale)
    np.testing.assert_allclose(err.numpy(), np.asarray(jerr), rtol=tol, atol=tol * float(jerr[0]))


def test_cg_block_makes_no_host_read_or_copy(monkeypatch):
    Kn, E = 12, 13
    op = pose_graph._CGSystem(
        Ji=torch.zeros(E, 7, 7), Jj=torch.zeros(E, 7, 7), wJi=torch.zeros(E, 7, 7),
        wJj=torch.zeros(E, 7, 7), ei=torch.zeros(E, dtype=torch.int64), ej=torch.ones(E, dtype=torch.int64),
        ends=torch.zeros(2 * E, dtype=torch.int64),
        plan=pose_graph.sum_plan(torch.zeros(2 * E, dtype=torch.int64), Kn),
        pin7=torch.zeros(Kn, 7, dtype=torch.bool), Dinv=torch.zeros(Kn, 7, 7))
    x = torch.zeros(Kn, 7)
    _runs_on_meta(pose_graph._cg_block, dict(n=pose_graph.CG_CHECK_EVERY, lam=1e-6), dict(
        op=op, x=x, r=x, p=x, gamma=torch.ones(()), n_active=torch.zeros((), dtype=torch.int32),
        atol2=torch.ones(())), monkeypatch)


# ----------------------------------------------------------------- card

def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _to(tree, dev):
    return _on(tree, lambda t: t.to(dev))


@pytest.mark.cuda
def test_batched_step_and_cg_graphed_equal_eager_on_card(step_inputs):
    """The batched step (B=2) and the CG solve on the card: graphed (one
    capture, then replays) equal to eager, bit for bit."""
    _cuda()
    args = [array_to_tensor(np.concatenate([step_inputs[k]] * 2), "cuda") for k in TRACK_STEP_ARGS]
    graphs = StepGraphs("cuda")
    eager = track_step_batched(STEP_CAM, STEP_CFG, *args)
    for _ in range(2):
        assert _equal(track_step_batched(STEP_CAM, STEP_CFG, *args, run=graphs.run), eager)
    assert graphs.captures == 1 and graphs.replays == 2

    s0, R0, t0, e = _to(drifted_loop(60, loop_pairs=((None, 0), (30, 0))), "cuda")
    fixed = torch.zeros(60, dtype=torch.bool, device="cuda")
    fixed[0] = True
    valid = torch.ones(60, dtype=torch.bool, device="cuda")
    st_g, st_e = {}, {}
    g = pose_graph.optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=6, dense_max_nodes=4, stats=st_g)
    ee = pose_graph.optimize_pose_graph(s0, R0, t0, valid, fixed, e, iters=6, dense_max_nodes=4,
                                        stats=st_e, run=call_segment)
    assert _equal(g, ee) and st_g["reads"] == st_e["reads"]
    assert st_g["cg_graph"]["captures"] >= 1 and st_g["cg_graph"]["replays"] > st_g["cg_graph"]["captures"]


@pytest.mark.cuda
def test_multitracker_graphed_equals_eager_on_card(stereo_streams):
    _cuda()
    runs = []
    for graphed in (True, False):
        mt = MultiTracker.uniform(TrackerConfig(cam=MULTI_CAM, orb=MULTI_ORB, **MULTI_KW), 2, device="cuda")
        if not graphed:
            mt.graphs.run = call_segment
            for tr in mt.trackers:
                tr.graphs.run = call_segment
        outs = [mt.track_stereo(torch.stack([f[i][0] for f in stereo_streams]).cuda(),
                                torch.stack([f[i][1] for f in stereo_streams]).cuda(), i)
                for i in range(MULTI_FRAMES)]
        runs.append((mt, outs))
    (a, out_a), (b, out_b) = runs
    assert a.graphs.replays == MULTI_FRAMES and a.graphs.captures == 1
    for x, y in zip(out_a, out_b):
        for p, q in zip(x, y):
            assert (p is None) == (q is None)
            if p is not None:
                assert np.array_equal(p[0], q[0]) and np.array_equal(p[1], q[1])
    for ta, tb in zip(a.trackers, b.trackers):
        for name, x in ta.map._asdict().items():
            assert torch.equal(x, getattr(tb.map, name)), name


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["bow", "mbvo"])
def test_relocalization_and_vo_graphed_equal_eager_on_card(session, depth_frames, case):
    """Relocalization (its BoW branch) and a localization-mode mbVO frame
    (the motion model and relocalization) on the card: graphed (captured
    at the first call, replayed at the second) equal to eager."""
    _cuda()
    s, st, feats = session
    feats_d, last_d = depth_frames
    st = _to(st, "cuda")
    feats, feats_d, last_d = (_to(f, "cuda") for f in (feats, feats_d, last_d))
    results, graphs = [], None
    for way in ("graphed", "eager", "graphed"):
        if case == "bow":
            tr = _tracker(st, "cuda")
            tr._reloc_candidate_kfs = lambda f: [st.ref_kf, 0]
        else:
            tr = _loc_tracker(st, feats_d, last_d, "mbvo", "cuda")
        if way == "eager":
            tr.graphs.run = call_segment
        elif graphs is not None:
            tr.graphs = graphs  # the second graphed run replays the first's graphs
        ok = tr._relocalize(feats, 99) if case == "bow" else tr._track_frame_localization(feats_d, SNAP)
        if way == "graphed":
            graphs = tr.graphs
        results.append((ok, tr._last_R, tr._last_t, tr._last_obs))
    assert graphs.captures > 0 and graphs.replays > graphs.captures
    for r in (results[0], results[2]):
        assert r[0] == results[1][0]
        for a, b in zip(r[1:], results[1][1:]):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_segment_with_cusolver_raises_on_card():
    """A segment with an eigh (cuSOLVER checks its status on the host)
    cannot be captured: StepGraphs.run raises and runs nothing eagerly in
    its place (a child process: a failed capture may leave the CUDA
    context unusable). Relocalization therefore runs EPnP's eigh and SVD
    between its segments."""
    _cuda()
    code = (
        "import torch\n"
        "from tpuslam_torch.pipeline.graphs import StepGraphs\n"
        "calls = []\n"
        "def seg(A):\n"
        "    calls.append(1)\n"
        "    return torch.linalg.eigh(A @ A.mT)[1]\n"
        "g = StepGraphs('cuda')\n"
        "try:\n"
        "    g.run('eigh', seg, {}, A=torch.randn(128, 12, 12, device='cuda'))\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, 'calls', len(calls), 'captures', g.captures, 'replays', g.replays)\n"
        "else:\n"
        "    print('no raise')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert "raised" in out.stdout and "calls 2 captures 0 replays 0" in out.stdout, out.stdout + out.stderr
