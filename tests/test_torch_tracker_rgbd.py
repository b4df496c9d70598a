"""The port's RGB-D System end to end on the CPU, against the JAX package's
System on the same frames, and the RGB-D frame construction.

The scenario is tests/test_integration_stereo.py's RGB-D one: 25 rendered
frames of StepWallScene at 320x240, 500 ORB features, 30 keyframes, 8000
points, kf_max_frames 8, loop closing off. The depth image is given as a
dataset stores it, uint16 at 5000 units per metre, with depth_map_factor
1/5000 (TUM1.yaml's DepthMapFactor 5000), to both Systems. ThDepth 40 on a
0.12 m virtual baseline puts the threshold at 4.8 m, inside the scene's
3.5 to 7 m, so both the close and the far branches run. The port is held
to the integration gates (OK, >= 2 keyframes, > 200 points, >= 23 tracked,
span within 5%, rigid ATE < 5 cm), and against the JAX System: the first
map's point count equal, every camera centre before the first keyframe job
within 0.1 mm, both rigid ATEs within 2 cm of each other (fusion parts the
sessions after that, at MapPoint::PredictScale's octave edges:
tests/test_torch_tracker_stereo.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.ops.orb import ORBConfig as JORBConfig
from tpuslam.pipeline import SensorType as JSensorType, System as JSystem
from tpuslam.pipeline.tracker import Tracker as JTracker, TrackerConfig as JTrackerConfig
from tpuslam_torch.convert import features_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig, extract_orb
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig
from tpuslam_torch.testing import (
    StepWallScene,
    depth_session,
    orbit_trajectory,
    render_rgbd_frames,
    trajectory_ate,
)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=350.0 * 0.12, width=320, height=240)
KW = dict(max_keyframes=30, max_points=8000, kf_max_frames=8, enable_loop_closing=False,
          depth_map_factor=1.0 / 5000.0)
N_FRAMES = 25


def centres(trajectory):
    return {fid: -R.T @ t for fid, R, t, lost in trajectory if not lost}


def span(c: dict) -> float:
    keys = sorted(c)
    return float(np.linalg.norm(c[keys[-1]] - c[keys[0]]))


@pytest.fixture(scope="module")
def scenario():
    scene = StepWallScene(np.random.default_rng(6))
    poses = orbit_trajectory(N_FRAMES, step=0.05)
    return poses, render_rgbd_frames(scene, CAM, poses)


def first_map(system, record):
    def on_frame(i, out):
        if "n_pt" not in record and system.tracker.state.name == "OK":
            record.update(frame=i, n_pt=int(np.asarray(system.tracker.map.pt_valid).sum()))
    return on_frame


@pytest.fixture(scope="module")
def port_run(scenario):
    _, frames = scenario
    system = System(CAM, SensorType.RGBD, orb=ORBConfig(n_features=500), device="cpu", **KW)
    record = {}
    res = depth_session(system, frames, on_frame=first_map(system, record))
    record["first_kf_frame"] = int(system.tracker.map.kf_frame_id[1])
    return system, record, res


@pytest.fixture(scope="module")
def jax_run(scenario):
    _, frames = scenario
    system = JSystem(JCamera(**CAM._asdict()), JSensorType.RGBD, orb=JORBConfig(n_features=500), **KW)
    record = {}
    on_frame = first_map(system, record)
    for i, (img, depth) in enumerate(frames):
        system.track_rgbd(jnp.asarray(img.numpy()), jnp.asarray(depth.astype(np.float32)), i / 30.0)
        on_frame(i, None)
    return system, record


def test_rgbd_frames_are_tum_depth_images(scenario):
    _, frames = scenario
    img, depth = frames[0]
    assert img.dtype == torch.float32 and depth.dtype == np.uint16 and depth.shape == (240, 320)
    z = depth[depth > 0] / 5000.0
    assert z.min() > 3.0 and z.max() < 8.0
    assert (z < 4.8).mean() > 0.1 and (z > 4.8).mean() > 0.1  # both sides of th_depth


def test_port_rgbd_session_passes_the_integration_gates(port_run, scenario):
    system, record, res = port_run
    stats = system.map_stats()
    assert record["frame"] == 0
    assert stats["state"] == "OK" and stats["n_keyframes"] >= 2 and stats["n_points"] > 200
    traj = system.tracker.export_trajectory()
    c = centres(traj)
    assert len(c) >= 23, f"only {len(c)} tracked"
    gt = centres([(i, np.asarray(R), np.asarray(t), False) for i, (R, t) in enumerate(scenario[0])])
    assert abs(span(c) - span(gt)) / span(gt) < 0.05, (span(c), span(gt))
    ate, _, _ = trajectory_ate(traj, scenario[0], fix_scale=True)
    assert ate < 0.05, f"rgbd ATE {ate:.4f} m"
    assert all(out is not None for out, _ in res)


def test_port_rgbd_session_matches_the_jax_session(port_run, jax_run, scenario):
    system, rec, _ = port_run
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


def test_keyframes_densify_from_close_depths(port_run):
    """Every keyframe after the first adds points of its own, all closer
    than th_depth at creation (the far keypoints stay unmapped)."""
    system, _, _ = port_run
    tr = system.tracker
    m = tr.map
    th = tr._th_depth
    assert th == pytest.approx(4.8)
    for k in range(1, tr._n_kf_host):
        own = m.pt_valid & (m.pt_first_kf == k)
        if not bool(own.any()):
            continue
        C = -(m.kf_R[k].T @ m.kf_t[k])
        d = torch.linalg.norm(m.pt_xyz[own] - C, dim=-1)
        assert float(d.median()) < th + 0.5
    assert bool((m.pt_valid & (m.pt_first_kf >= 1)).any())


def test_frame_features_rgbd_matches_jax(scenario):
    """Frame::ComputeStereoFromRGBD on a distorted camera: the depth image
    is read at each keypoint's raw position, u_right from the undistorted
    one. The JAX tracker's extraction is given the port's ORBFeatures, so
    both read the same keypoints; undistortion within 1e-4 px."""
    cam = CAM._replace(k1=-0.2, k2=0.05, p1=0.001, p2=-0.001)
    img, depth = scenario[1][3]
    depth = torch.from_numpy(depth.astype(np.float32))
    port = Tracker(TrackerConfig(cam=cam, orb=ORBConfig(n_features=500), **KW), device="cpu")
    got = port._frame_features_rgbd(img, depth)
    ref_t = JTracker(JTrackerConfig(cam=JCamera(**cam._asdict()), orb=JORBConfig(n_features=500), **KW))
    f = extract_orb(img, ORBConfig(n_features=500))
    from tpuslam.ops.orb import ORBFeatures as JFeatures

    ref_t._extract = lambda _img: JFeatures(*(jnp.asarray(x) for x in features_to_numpy(f)))
    ref = ref_t._frame_features_rgbd(jnp.asarray(img.numpy()), jnp.asarray(depth.numpy()))
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), rtol=0, atol=1e-4)
    np.testing.assert_array_equal(got.depth.numpy(), np.asarray(ref.depth))
    np.testing.assert_allclose(got.u_right.numpy(), np.asarray(ref.u_right), rtol=0, atol=1e-4)
    has = got.depth > 0
    assert int(has.sum()) > 200
    # The raw and the undistorted positions differ: the lookup used the raw one.
    raw = f.xy
    assert float((raw - got.xy).abs().max()) > 1.0
    u = torch.clamp(torch.round(raw[:, 0]).long(), 0, 319)
    v = torch.clamp(torch.round(raw[:, 1]).long(), 0, 239)
    assert torch.equal(got.depth[has], depth[v, u][has] * np.float32(1.0 / 5000.0))


def test_system_takes_uint16_depth_and_tensors(scenario):
    """track_rgbd converts numpy uint16 and tensors alike to float32 on the
    tracker's device."""
    _, frames = scenario
    img, depth = frames[0]
    a = System(CAM, SensorType.RGBD, orb=ORBConfig(n_features=500), device="cpu", **KW)
    b = System(CAM, SensorType.RGBD, orb=ORBConfig(n_features=500), device="cpu", **KW)
    ra = a.track_rgbd(img.numpy(), depth, 0.0)
    rb = b.track_rgbd(img, torch.from_numpy(depth.astype(np.int32)), 0.0)
    assert ra is not None and rb is not None
    assert a.map_stats() == b.map_stats() and a.map_stats()["n_points"] > 200
