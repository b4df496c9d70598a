"""The port's monocular System end to end on the CPU, against the JAX
package's System on the same frames.

The scenario is tests/test_integration_mono.py's: 36 rendered frames of
StepWallScene at 320x240, 800 ORB features, 40 keyframes, 6000 points,
kf_max_frames 10, with loop closing off here (that file runs it on, and so
does tests/test_torch_tracker_loop.py). The port's session is held to that
file's gates: state OK, >= 3 keyframes, > 150 points, > 25
tracked frames, ATE < 0.03 after Sim3 alignment, valid TUM and KITTI files.

The JAX System runs the same frames once. The port replays the JAX
tracker's key chain (Tracker._next_key: split, then jax.random.randint) for
its RANSAC hypotheses, so both initialize from the same hypothesis sets.
Features differ by the jitted JAX pyramid's rounding, so the initial map
agrees within 2% of its point count and 1e-2 in pose, and the two sessions'
ATE within 0.01 of each other.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.ops.orb import ORBConfig as JORBConfig
from tpuslam.pipeline import SensorType as JSensorType, System as JSystem
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.tracker import Tracker, TrackerConfig, TrackingState
from tpuslam_torch.testing import (
    StepWallScene,
    mono_session,
    orbit_trajectory,
    render_frames,
    trajectory_ate,
)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)
KW = dict(max_keyframes=40, max_points=6000, kf_max_frames=10, enable_loop_closing=False)
N_FRAMES = 36


def replay_jax_keys(tracker):
    """Draw the tracker's hypotheses as the JAX tracker does: split its key
    (PRNGKey(0)) once per solver call, then randint in [0, max(n_valid, k))."""
    key = [jax.random.PRNGKey(0)]

    def draw(n_hyp, size, valid):
        key[0], k = jax.random.split(key[0])
        hi = max(int(valid.sum()), size)
        return torch.from_numpy(np.array(jax.random.randint(k, (n_hyp, size), 0, hi)))

    tracker._draw_picks = draw


def first_map(system, record):
    """After each frame: the frame id, keyframe poses and point count of the
    first initialized map."""
    def on_frame(i, out):
        tr = system.tracker
        if "frame" not in record and tr.state.name == "OK":
            m = tr.map
            record.update(frame=i, kf_R=np.asarray(m.kf_R[:2]), kf_t=np.asarray(m.kf_t[:2]),
                          n_pt=int(np.asarray(m.pt_valid).sum()))
    return on_frame


@pytest.fixture(scope="module")
def scenario():
    scene = StepWallScene(np.random.default_rng(11))
    return scene, orbit_trajectory(N_FRAMES, step=0.045)


@pytest.fixture(scope="module")
def port_run(scenario):
    scene, poses = scenario
    system = System(CAM, SensorType.MONOCULAR, orb=ORBConfig(n_features=800), device="cpu", **KW)
    replay_jax_keys(system.tracker)
    record = {}
    frames = render_frames(scene, CAM, poses)
    mono_session(system, frames, on_frame=first_map(system, record))
    return system, record, frames


@pytest.fixture(scope="module")
def jax_run(scenario):
    scene, poses = scenario
    system = JSystem(JCamera(**CAM._asdict()), JSensorType.MONOCULAR, orb=JORBConfig(n_features=800), **KW)
    record = {}
    on_init = first_map(system, record)
    for i, (R, t) in enumerate(poses):
        system.track_monocular(jnp.asarray(scene.render(CAM, R, t)), timestamp=i / 30.0)
        on_init(i, None)
    return system, record


def test_port_session_passes_the_integration_gates(port_run, scenario):
    system, _, _ = port_run
    stats = system.map_stats()
    assert stats["state"] == "OK", f"tracker ended in {stats['state']}"
    assert stats["n_keyframes"] >= 3
    assert stats["n_points"] > 150
    ate, n, _ = trajectory_ate(system.tracker.export_trajectory(), scenario[1])
    assert n > 25, f"only {n} tracked frames"
    assert ate < 0.03, f"ATE RMSE {ate:.4f}"
    # Every keyframe after the first two came with LocalMapping's points.
    m = system.tracker.map
    assert bool(((m.pt_first_kf >= 2) & m.pt_valid).any())


def test_port_session_matches_the_jax_session(port_run, jax_run, scenario):
    """The same initialization frame, the same two-keyframe map up to the
    features' rounding, and the same accuracy."""
    _, rec = port_run[:2]
    jsys, jrec = jax_run
    assert rec["frame"] == jrec["frame"]
    np.testing.assert_allclose(rec["kf_R"], jrec["kf_R"], atol=1e-2)
    np.testing.assert_allclose(rec["kf_t"], jrec["kf_t"], atol=1e-2)
    assert abs(rec["n_pt"] - jrec["n_pt"]) <= 0.02 * jrec["n_pt"]
    ate, _, _ = trajectory_ate(port_run[0].tracker.export_trajectory(), scenario[1])
    jate, jn, _ = trajectory_ate(jsys.tracker.export_trajectory(), scenario[1])
    assert jn > 25 and jate < 0.03
    assert abs(ate - jate) < 0.01, (ate, jate)


def test_tum_export_format(port_run, tmp_path):
    system = port_run[0]
    p = tmp_path / "traj.txt"
    system.save_trajectory_tum(str(p))
    lines = p.read_text().strip().splitlines()
    assert len(lines) > 25
    row = lines[0].split()
    assert len(row) == 8
    q = np.array([float(x) for x in row[4:]])
    assert abs(np.linalg.norm(q) - 1.0) < 1e-3 and q[3] >= 0
    # The first row is the initialization frame at its timestamp.
    assert float(row[0]) == pytest.approx(port_run[1]["frame"] / 30.0, abs=1e-6)


def test_keyframe_tum_export_format(port_run, tmp_path):
    system = port_run[0]
    p = tmp_path / "kf.txt"
    system.save_keyframe_trajectory_tum(str(p))
    lines = p.read_text().strip().splitlines()
    assert len(lines) == int(system.tracker.map.kf_valid.sum())
    ts = [float(line.split()[0]) for line in lines]
    assert ts == sorted(ts) and all(len(line.split()) == 8 for line in lines)


def test_kitti_export_format(port_run, tmp_path):
    system = port_run[0]
    p = tmp_path / "traj_kitti.txt"
    system.save_trajectory_kitti(str(p))
    lines = p.read_text().strip().splitlines()
    assert len(lines) > 25 and len(lines[0].split()) == 12
    M = np.array([float(x) for x in lines[-1].split()]).reshape(3, 4)
    np.testing.assert_allclose(M[:, :3] @ M[:, :3].T, np.eye(3), atol=1e-4)


def test_relocalizes_after_a_forced_loss(port_run, scenario):
    """LOST on the finished map (as tests/test_tracking_policy.py forces it),
    then an earlier frame: the brute-force match and EPnP bring it back, at
    its true camera centre under the session's Sim3 alignment."""
    system = copy.deepcopy(port_run[0])
    _, frames = port_run[1:]
    tr = system.tracker
    _, _, (s, Ra, ta) = trajectory_ate(tr.export_trajectory(), scenario[1])
    tr.state = TrackingState.LOST
    tr._velocity = None
    i = 20
    out = system.track_monocular(frames[i], 99.0)
    assert out is not None and tr.state == TrackingState.OK
    assert tr._last_reloc_frame_id == N_FRAMES
    R, t = out
    Rg, tg = scenario[1][i]
    centre = s * (-R.T @ t) @ Ra.T + ta
    assert np.linalg.norm(centre - (-Rg.T @ tg)) < 0.03


def test_keyframe_slots_are_recycled_at_capacity(scenario):
    """A 6-keyframe map over 16 frames, with tests/test_kf_recycling.py's
    small protect window: culled or force-evicted slots are reused and the
    trajectory still resolves."""
    scene, poses = scenario
    system = System(CAM, orb=ORBConfig(n_features=500), device="cpu",
                    **{**KW, "max_keyframes": 6, "kf_max_frames": 2, "local_ba_window": 3})
    mono_session(system, render_frames(scene, CAM, poses[:16]))
    tr = system.tracker
    assert tr.state == TrackingState.OK
    assert tr.n_recycled_kf_slots > 0
    assert int(tr.map.n_kf) == 6 and tr._n_kf_host == 6
    ate, n, _ = trajectory_ate(tr.export_trajectory(), poses)
    assert n >= 12 and ate < 0.05


@pytest.mark.parametrize("kw, item", [
    (dict(async_mapping=True), "A12"),
    (dict(mapping_process=True), "A12"),
    (dict(dist_ba_devices=2), "A12"),
])
def test_unported_config_flags_raise(kw, item):
    with pytest.raises(NotImplementedError, match=item):
        Tracker(TrackerConfig(cam=CAM, **{**KW, **kw}), device="cpu")


def test_tracker_defaults_match_jax():
    """Every field and default of the JAX package's TrackerConfig, and the
    entry points on the card unless asked."""
    import dataclasses
    import inspect

    from tpuslam.pipeline.tracker import TrackerConfig as JTrackerConfig

    jf = {f.name: f.default for f in dataclasses.fields(JTrackerConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(TrackerConfig)}
    assert set(tf) - set(jf) == {"seed"}
    for name, default in jf.items():
        if name != "orb":
            assert tf[name] == default, name
    assert dataclasses.asdict(tf["orb"]) == dataclasses.asdict(jf["orb"])
    assert inspect.signature(Tracker).parameters["device"].default == "cuda"
    assert inspect.signature(System).parameters["device"].default == "cuda"


def test_localization_mode_features_entry_and_reset(port_run):
    """Localization mode tracks without inserting keyframes, the features
    entry tracks precomputed FrameFeatures, and reset empties the map."""
    system = copy.deepcopy(port_run[0])
    frames = port_run[2]
    tr = system.tracker
    n_kf = tr._n_kf_host
    system.activate_localization_mode()
    for i in (N_FRAMES - 2, N_FRAMES - 1):
        assert system.track_monocular(frames[i], 50.0 + i) is not None
    assert tr._n_kf_host == n_kf and tr.state == TrackingState.OK
    system.deactivate_localization_mode()
    out = tr.track_monocular_features(tr._frame_features(frames[-1]), tr.n_frames)
    assert out is not None and out[0].shape == (3, 3)
    system.reset()
    assert system.state == TrackingState.NO_IMAGES_YET
    assert system.map_stats() == {"n_keyframes": 0, "n_points": 0, "state": "NO_IMAGES_YET"}
    assert tr.export_trajectory() == []
    system.shutdown()
