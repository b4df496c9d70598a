"""The port's per-frame tracking step over a real MapState against the JAX
package's, on the CPU, dense regime (every valid point is a candidate).

The map is built by the port alone (testing.build_depth_session) at
320x240, 300 features, K=8 keyframes, 600 keypoint slots, P=4096 points,
and crosses to JAX through numpy. `fused_track_frame` gets the same
FrameFeatures on both sides, so only the tracking arithmetic differs: the
JAX step runs under jit, where XLA:CPU fuses multiply-adds, so poses agree
within 1e-3 and every integer, index and mask exactly. From the image
(`fused_track_frame_image`) the jitted JAX pyramid moves keypoints by up
to a pixel, hence the looser tolerances there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.mapstate import core as jcore
from tpuslam.ops.orb import ORBConfig as JORBConfig
from tpuslam.pipeline import steps as jsteps
from tpuslam_torch.convert import frame_features_to_numpy, map_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops.orb import ORBConfig, extract_orb
from tpuslam_torch.pipeline import steps as tsteps
from tpuslam_torch.testing import (
    StepWallScene,
    build_depth_session,
    depth_at,
    orb_frame_features,
    orbit_trajectory,
    pose_errors,
)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CFG = ORBConfig(n_features=300)
K, N_CAP, P = 8, 600, 4096
SNAP = 8  # frame 7 follows a keyframe (reference branch); 8 has a velocity
INT_FIELDS = [tsteps.FUSED_ACCEPT, tsteps.FUSED_INITIAL_OK, tsteps.FUSED_USED_MM,
              tsteps.FUSED_N_TRACKED, *range(tsteps.FUSED_GATES, tsteps.FUSED_GATES + 4),
              tsteps.FUSED_NM]


@pytest.fixture(scope="module")
def session():
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(SNAP + 1, step=0.02, x0=-0.5, yaw_rate=0.002)
    s = build_depth_session(scene, CAM, CFG, poses, K, N_CAP, P, kf_every=3, snapshot_at=(SNAP,))
    _, z = scene.render(CAM, *poses[SNAP], with_depth=True, device="cpu")
    return s, poses, z


def _jax_state(st):
    return dict(
        m=jcore.MapState(*(jnp.asarray(x) for x in map_to_numpy(st.m))),
        last_feats=jcore.FrameFeatures(*(jnp.asarray(x) for x in frame_features_to_numpy(st.last_feats))),
        last_obs=jnp.asarray(st.last_obs.numpy()),
        last_R=jnp.asarray(st.last_R.numpy()), last_t=jnp.asarray(st.last_t.numpy()),
    )


def _vel(st, has_vel):
    if has_vel:
        return st.vel_R, st.vel_t
    return torch.eye(3), torch.zeros(3)


def _features(s, depth=None):
    _, img = s.snapshots[SNAP]
    return orb_frame_features(extract_orb(img, CFG), depth)


def _run_both(s, feats, has_vel, depth=False, th_depth=0.0, **kw):
    st, _ = s.snapshots[SNAP]
    vel_R, vel_t = _vel(st, has_vel)
    j = _jax_state(st)
    ref = jsteps.fused_track_frame(
        JCamera(**CAM._asdict()), j["m"], j["last_feats"], j["last_obs"], j["last_R"], j["last_t"],
        jnp.asarray(vel_R.numpy()), jnp.asarray(vel_t.numpy()), jnp.asarray(has_vel),
        jcore.FrameFeatures(*(jnp.asarray(x) for x in frame_features_to_numpy(feats))),
        jnp.int32(st.ref_kf), jnp.asarray(s.inv_sigma2.numpy()), jnp.float32(th_depth),
        jnp.float32(30.0), depth=depth, **kw,
    )
    got = tsteps.fused_track_frame(
        CAM, st.m, st.last_feats, st.last_obs, st.last_R, st.last_t, vel_R, vel_t, has_vel,
        feats, st.ref_kf, s.inv_sigma2, th_depth, 30.0, depth=depth, **kw,
    )
    return [np.asarray(x) for x in ref], [x.numpy() for x in got]


def assert_step_matches(ref, got, pose_tol=1e-3):
    """(R, t, obs, vel_R, vel_t, pt_visible, pt_found, packed)."""
    jR, jt, jobs, jvR, jvt, jvis, jfound, jp = ref
    R, t, obs, vR, vt, vis, found, p = got
    np.testing.assert_array_equal(p[INT_FIELDS], jp[INT_FIELDS])
    np.testing.assert_array_equal(obs, jobs)
    np.testing.assert_array_equal(vis, jvis)
    np.testing.assert_array_equal(found, jfound)
    for a, b in ((R, jR), (t, jt), (vR, jvR), (vt, jvt), (p, jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=pose_tol)


@pytest.mark.parametrize("has_vel", [True, False])
def test_fused_track_frame_matches_jax(session, has_vel):
    """With a velocity the motion model leads; without one, the reference
    keyframe. Both then run TrackLocalMap over the whole map."""
    s, poses, _ = session
    ref, got = _run_both(s, _features(s), has_vel)
    assert_step_matches(ref, got)
    p = got[-1]
    assert p[tsteps.FUSED_ACCEPT] == 1 and p[tsteps.FUSED_USED_MM] == float(has_vel)
    assert p[tsteps.FUSED_N_TRACKED] >= 100
    t_err, r_err = pose_errors(got[0][None], got[1][None], poses[SNAP][0][None], poses[SNAP][1][None])
    assert t_err[0] < 0.03 and r_err[0] < 0.3


def test_fused_track_frame_depth_gates_match_jax(session):
    """Features that carry depth: the close-point gates of NeedNewKeyFrame,
    with a threshold that splits them."""
    s, _, z = session
    feats = _features(s)
    feats = feats._replace(depth=depth_at(z, feats.xy))
    ref, got = _run_both(s, feats, True, depth=True, th_depth=4.5)
    assert_step_matches(ref, got)
    gates = got[-1][tsteps.FUSED_GATES:tsteps.FUSED_GATES + 4]
    assert gates[2] > 10 and gates[3] > 10


def test_fused_track_frame_image_matches_jax(session):
    s, poses, _ = session
    st, img = s.snapshots[SNAP]
    j = _jax_state(st)
    jout = jsteps.fused_track_frame_image(
        JCamera(**CAM._asdict()), JORBConfig(n_features=300), j["m"], jnp.asarray(img.numpy()),
        j["last_feats"], j["last_obs"], j["last_R"], j["last_t"],
        jnp.asarray(st.vel_R.numpy()), jnp.asarray(st.vel_t.numpy()), jnp.asarray(True),
        jnp.int32(st.ref_kf), jnp.asarray(s.inv_sigma2.numpy()), jnp.float32(30.0),
    )
    tout = tsteps.fused_track_frame_image(
        CAM, CFG, st.m, img, st.last_feats, st.last_obs, st.last_R, st.last_t,
        st.vel_R, st.vel_t, True, st.ref_kf, s.inv_sigma2, 30.0,
    )
    jp, p = np.asarray(jout[-1]), tout[-1].numpy()
    np.testing.assert_allclose(tout[1].numpy(), np.asarray(jout[1]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(tout[2].numpy(), np.asarray(jout[2]), rtol=0, atol=2e-3)
    assert p[tsteps.FUSED_ACCEPT] == jp[tsteps.FUSED_ACCEPT] == 1
    n, jn = p[tsteps.FUSED_N_TRACKED], jp[tsteps.FUSED_N_TRACKED]
    assert abs(n - jn) <= 0.03 * jn
    # The features out of the port's step are its extractor's.
    f = tout[0]
    assert f.xy.shape == (300, 2) and bool((f.u_right == -1).all()) and bool((f.depth == 0).all())


def test_session_tracks_every_frame(session):
    """The session itself: every frame accepted near its ground truth,
    both branches taken, a keyframe every third accepted frame."""
    s, _, _ = session
    p = np.stack([f["packed"] for f in s.frames])
    assert (p[:, tsteps.FUSED_ACCEPT] == 1).all()
    assert (p[:, tsteps.FUSED_N_TRACKED] >= 100).all()
    used_mm = p[:, tsteps.FUSED_USED_MM]
    assert used_mm.sum() >= 4 and (used_mm == 0).sum() >= 2
    assert [f["frame"] for f in s.frames if f["keyframe"]] == [3, 6]
    assert s.n_kf == 3 and int(s.state.m.n_kf) == 3
    R = np.stack([f["R"] for f in s.frames])
    t = np.stack([f["t"] for f in s.frames])
    t_err, r_err = pose_errors(R, t, np.stack([f["R_gt"] for f in s.frames]),
                               np.stack([f["t_gt"] for f in s.frames]))
    assert (t_err < 0.03).all() and (r_err < 0.3).all()
    m = s.state.m
    assert int(m.pt_valid.sum()) == int(m.n_pt) > 300
