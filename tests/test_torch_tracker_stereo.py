"""The port's stereo System end to end on the CPU, against the JAX
package's System on the same frames, plus NeedNewKeyFrame's depth-sensor
policy and localization mode with visual-odometry points.

The scenario is tests/test_integration_stereo.py's: 25 rendered stereo
pairs of StepWallScene at 320x240 (a 0.12 m baseline), 500 ORB features,
30 keyframes, 8000 points, kf_max_frames 8, loop closing off (not ported
yet). The port is held to that file's gates: state OK, >= 2 keyframes,
> 200 points, >= 23 tracked frames, the span within 5% of the truth (depth
gives true scale) and the ATE after a rigid alignment below 5 cm.

Against the JAX System on the same frames: the first keyframe's map point
count equal, and every camera centre up to the first keyframe job within
0.1 mm of the JAX one (no RANSAC runs: a stereo map starts from one
keyframe of depths). From the first keyframe job on the sessions part:
every point of a stereo map is created from its own keyframe's depth, so
fusion meets many points whose MapPoint::PredictScale ratio is exactly a
power of 1.2, where the float32 norms and logs of torch and XLA can round
apart and move the octave window (the documented limit of exact parity,
tests/test_torch_mapping.py). The fusion test below checks that this is
the only cause; the sessions are then held to each other by accuracy: both
rigid ATEs under the 5 cm gate and within 2 cm of each other (the JAX
session's 1.7 cm against the port's 0.4 cm when this was written).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.ops.orb import ORBConfig as JORBConfig
from tpuslam.mapstate import core as jcore
from tpuslam.pipeline import SensorType as JSensorType, System as JSystem
from tpuslam.pipeline import steps as jsteps
from tpuslam.pipeline.tracker import Tracker as JTracker, TrackerConfig as JTrackerConfig
from tpuslam_torch.convert import map_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline import steps as tsteps
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig, TrackingState
from tpuslam_torch.testing import (
    StepWallScene,
    depth_session,
    keep_mapping_inputs,
    orbit_trajectory,
    render_stereo_frames,
    trajectory_ate,
)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=350.0 * 0.12, width=320, height=240)
KW = dict(max_keyframes=30, max_points=8000, kf_max_frames=8, enable_loop_closing=False)
N_FRAMES = 25


def centres(trajectory):
    return {fid: -R.T @ t for fid, R, t, lost in trajectory if not lost}


def span(c: dict) -> float:
    keys = sorted(c)
    return float(np.linalg.norm(c[keys[-1]] - c[keys[0]]))


@pytest.fixture(scope="module")
def scenario():
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(N_FRAMES, step=0.05)
    return poses, render_stereo_frames(scene, CAM, poses)


def first_map(system, record):
    def on_frame(i, out):
        if "n_pt" not in record and system.tracker.state.name == "OK":
            record.update(frame=i, n_pt=int(np.asarray(system.tracker.map.pt_valid).sum()))
    return on_frame


@pytest.fixture(scope="module")
def port_run(scenario):
    poses, frames = scenario
    system = System(CAM, SensorType.STEREO, orb=ORBConfig(n_features=500), device="cpu", **KW)
    record = {}
    kept = keep_mapping_inputs(system.tracker, jobs={0})
    depth_session(system, frames, on_frame=first_map(system, record))
    record["first_job"] = kept[0]
    record["first_kf_frame"] = int(system.tracker.map.kf_frame_id[1])
    return system, record


@pytest.fixture(scope="module")
def jax_run(scenario):
    poses, frames = scenario
    system = JSystem(JCamera(**CAM._asdict()), JSensorType.STEREO, orb=JORBConfig(n_features=500), **KW)
    record = {}
    on_frame = first_map(system, record)
    for i, (L, R) in enumerate(frames):
        system.track_stereo(jnp.asarray(L.numpy()), jnp.asarray(R.numpy()), i / 30.0)
        on_frame(i, None)
    return system, record


def test_port_stereo_session_passes_the_integration_gates(port_run, scenario):
    system, record = port_run
    stats = system.map_stats()
    assert record["frame"] == 0
    assert stats["state"] == "OK" and stats["n_keyframes"] >= 2 and stats["n_points"] > 200
    traj = system.tracker.export_trajectory()
    c = centres(traj)
    assert len(c) >= 23, f"only {len(c)} tracked"
    gt = centres([(i, np.asarray(R), np.asarray(t), False) for i, (R, t) in enumerate(scenario[0])])
    assert abs(span(c) - span(gt)) / span(gt) < 0.05, (span(c), span(gt))
    ate, _, (s, _, _) = trajectory_ate(traj, scenario[0], fix_scale=True)
    assert s == 1.0 and ate < 0.05, f"stereo ATE {ate:.4f} m"
    # Keyframes after the first added close-depth points of their own.
    m = system.tracker.map
    assert bool(((m.pt_first_kf >= 1) & m.pt_valid).any())


def test_port_stereo_session_matches_the_jax_session(port_run, jax_run, scenario):
    system, rec = port_run
    jsys, jrec = jax_run
    assert rec["frame"] == jrec["frame"] == 0
    assert rec["n_pt"] == jrec["n_pt"]
    c = centres(system.tracker.export_trajectory())
    jc = centres(jsys.tracker.export_trajectory())
    assert set(c) == set(jc)
    first_kf = rec["first_kf_frame"]
    assert first_kf == int(jsys.tracker.map.kf_frame_id[1]) and first_kf >= 3
    err = max(np.linalg.norm(c[k] - jc[k]) for k in range(first_kf))
    assert err < 1e-4, err
    ate, _, _ = trajectory_ate(system.tracker.export_trajectory(), scenario[0], fix_scale=True)
    jate, _, _ = trajectory_ate(jsys.tracker.export_trajectory(), scenario[0], fix_scale=True)
    assert ate < 0.05 and jate < 0.05 and abs(ate - jate) < 0.02, (ate, jate)


def on_octave_edge(m, src, dst, slots):
    """Whether keyframe src's points at `slots`, seen from keyframe dst, sit
    on an edge of MapPoint::PredictScale: ceil(log(r) / log(1.2)) with r =
    max_dist / dist within float error of an integer."""
    p = m.kf_obs_pt[src][slots].long()
    C = -(m.kf_R[dst].T @ m.kf_t[dst])
    r = (m.pt_max_dist[p] / torch.linalg.norm(m.pt_xyz[p] - C, dim=-1)).double()
    k = torch.log(r) / np.log(1.2)
    return (torch.abs(k - torch.round(k)) < 1e-5).numpy()


def test_fusion_on_a_stereo_map_matches_jax_but_at_octave_edges(port_run):
    """Fusion of the first keyframe job's two keyframes (both directions)
    against the JAX package, op by op: every differing match is a point on
    an octave edge, or one that competes with such a point for the same
    keypoint (one-to-one resolution)."""
    system, rec = port_run
    m, ki = rec["first_job"]
    P = m.capacity_pt
    has = (m.kf_obs_pt >= 0) & m.kf_kp_valid & m.kf_valid[:, None]
    cnt = torch.zeros(P + 1).index_add(0, torch.where(has, m.kf_obs_pt, P).reshape(-1).long(),
                                       torch.ones(has.numel()))[:P]
    jm = jcore.MapState(*(jnp.asarray(x) for x in map_to_numpy(m)))
    inv_s2 = system.tracker.inv_sigma2
    n_hits = n_diff = 0
    for s, d in ((ki, 0), (0, ki)):
        got = tsteps._fuse_pair_match(CAM, m, cnt, torch.tensor([s]), torch.tensor([d]), inv_s2,
                                      scale_factor=1.2, n_levels=8)
        with jax.disable_jit():
            ref = jsteps._fuse_pair_match(JCamera(**CAM._asdict()), jm, jnp.asarray(cnt.numpy()),
                                          jnp.int32(s), jnp.int32(d), jnp.asarray(inv_s2.numpy()),
                                          scale_factor=1.2, n_levels=8)
        tgt, add, merge, winner, loser = (np.asarray(x) for x in ref)
        g_tgt, g_add, g_merge, g_win, g_lose = (x[0].numpy() for x in got)
        live = add | merge | g_add | g_merge
        diff = ((g_add != add) | (g_merge != merge) | (live & (g_tgt != tgt))
                | (merge & ((g_win != winner) | (g_lose != loser))))
        rows = np.arange(len(diff))
        edge = on_octave_edge(m, s, d, rows) & (m.kf_obs_pt[s] >= 0).numpy()
        contested = set(g_tgt[edge].tolist()) | set(tgt[edge].tolist())
        explained = edge | np.isin(g_tgt, list(contested)) | np.isin(tgt, list(contested))
        assert explained[diff].all(), rows[diff & ~explained]
        n_diff += int(diff.sum())
        n_hits += int(live.sum())
    assert n_hits > 50 and n_diff <= 0.05 * n_hits, (n_diff, n_hits)


# NeedNewKeyFrame over a table of gate values: keyframes on the map, the
# reference keyframe's tracked points, tracked and untracked close points,
# tracked points, and frames since the last relocalization.
GATE_TABLE = [
    (n_kf, ref, close_t, close_u, n_tr, since_reloc)
    for n_kf in (1, 2, 9, 40)
    for ref in (0, 60, 400)
    for close_t, close_u in ((0, 0), (50, 80), (150, 80), (50, 60))
    for n_tr in (10, 16, 90, 250, 390)
    for since_reloc in (3, 100)
]


@pytest.mark.parametrize("depth", [True, False])
@pytest.mark.parametrize("frames_since_kf", [0, 1, 8])
def test_need_new_keyframe_matches_jax(depth, frames_since_kf):
    """The depth-sensor policy (close-point pressure, c1c, the 0.75 ratio)
    and the monocular one, with mapping idle, against the JAX tracker's
    decisions over the whole table."""
    kw = dict(max_keyframes=4, max_points=64, kf_max_frames=8, enable_loop_closing=False)
    port = Tracker(TrackerConfig(cam=CAM, orb=ORBConfig(n_features=100), **kw), device="cpu")
    ref = JTracker(JTrackerConfig(cam=JCamera(**CAM._asdict()), orb=JORBConfig(n_features=100), **kw))
    frame_id = 200
    for tr in (port, ref):
        tr._depth_mode = depth
        tr._frames_since_kf = frames_since_kf
    decisions = []
    for n_kf, ref_m, close_t, close_u, n_tr, since_reloc in GATE_TABLE:
        for tr in (port, ref):
            tr._last_reloc_frame_id = frame_id - since_reloc
        gates = np.array([n_kf, ref_m, close_t, close_u], np.float32)
        got = port._need_new_keyframe(n_tr, frame_id, gates)
        want = ref._need_new_keyframe(n_tr, frame_id, gates)
        assert got == want, (n_kf, ref_m, close_t, close_u, n_tr, since_reloc)
        decisions.append(got)
    assert 0 < sum(decisions) < len(decisions) or frames_since_kf == 0


@pytest.fixture(scope="module")
def localization_run():
    """tests/test_tracking_policy.py::TestLocalizationModeVO's scenario:
    map the first 12 of 30 frames (6 cm a frame), then localization mode
    past the mapped region."""
    scene = StepWallScene(np.random.default_rng(7))
    poses = orbit_trajectory(30, step=0.06)
    frames = render_stereo_frames(scene, CAM, poses)
    system = System(CAM, SensorType.STEREO, orb=ORBConfig(n_features=500), device="cpu", **KW)
    depth_session(system, frames[:12])
    assert system.tracker.state == TrackingState.OK
    mapped = copy.deepcopy(system.tracker.map)
    system.activate_localization_mode()
    tracked, vo = 0, False
    for i in range(12, 30):
        if system.track_stereo(*frames[i], i / 10.0) is not None:
            tracked += 1
        vo = vo or system.tracker._vo_mode
    return system, mapped, tracked, vo, poses


def test_localization_mode_vo_bridges_the_map_sparse_region(localization_run):
    """Temporal VO points keep the tracker alive past the mapped region, and
    the map stays frozen."""
    system, mapped, tracked, _, _ = localization_run
    m = system.tracker.map
    assert torch.equal(m.pt_valid, mapped.pt_valid) and torch.equal(m.pt_xyz, mapped.pt_xyz)
    assert torch.equal(m.kf_valid, mapped.kf_valid) and int(m.n_kf) == int(mapped.n_kf)
    assert tracked >= 14, f"only {tracked}/18 frames tracked past the map"


def test_localization_mode_poses_stay_metric(localization_run):
    """The frames tracked in localization mode lie on the true path: the
    rigid ATE of the whole session below 5 cm."""
    system, _, _, _, poses = localization_run
    ate, n, _ = trajectory_ate(system.tracker.export_trajectory(), poses, fix_scale=True)
    assert n >= 26 and ate < 0.05, (n, ate)


def test_reset_clears_the_depth_and_vo_state(localization_run):
    system = copy.deepcopy(localization_run[0])
    tr = system.tracker
    assert tr._depth_mode and tr._vo_valid is not None
    system.reset()
    assert not tr._depth_mode and not tr._vo_mode and tr._vo_xyz is None and tr._vo_valid is None
    assert system.map_stats() == {"n_keyframes": 0, "n_points": 0, "state": "NO_IMAGES_YET"}
