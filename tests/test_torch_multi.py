"""The port's MultiTracker on the CPU: B independent sessions with one
batched front end, against the same streams run one System each, and
against the JAX package's MultiTracker.

Stereo: B = 2 streams (two paths over one StepWallScene at 320x240, 500
features), all 2B images extracted in one batch per frame: one FAST+NMS
call, one descriptor gather, then one SAD gather per stream. Each stream's
trajectory equals its own System's (the batch changes no per-image
arithmetic), and agrees with the JAX MultiTracker's within 0.1 mm up to the
first keyframe job (after it fusion can part them: see
tests/test_torch_tracker_stereo.py). Mono: B = 2 streams initialize on
their own and then share the batched extraction; each equals its own
System.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.ops.orb import ORBConfig as JORBConfig
from tpuslam.pipeline.multi import MultiTracker as JMultiTracker
from tpuslam.pipeline.tracker import TrackerConfig as JTrackerConfig
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.ops import orb as torb
from tpuslam_torch.ops import stereo as tstereo
from tpuslam_torch.ops.orb import ORBConfig
from tpuslam_torch.pipeline.multi import MultiTracker
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.pipeline.tracker import TrackerConfig, TrackingState
from tpuslam_torch.testing import (
    StepWallScene,
    depth_session,
    mono_session,
    orbit_trajectory,
    render_frames,
    render_stereo_frames,
)

torch.set_num_threads(2)

CAM = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, bf=42.0, width=320, height=240)
KW = dict(max_keyframes=24, max_points=6000, kf_max_frames=8, enable_loop_closing=False)
N_STEREO, N_MONO = 10, 12


def centres(trajectory):
    return {fid: -R.T @ t for fid, R, t, lost in trajectory if not lost}


@pytest.fixture(scope="module")
def stereo_multi():
    scene = StepWallScene(np.random.default_rng(5))
    paths = [orbit_trajectory(N_STEREO, step=0.045),
             orbit_trajectory(N_STEREO, step=0.04, yaw_rate=-0.003, x0=-0.3)]
    frames = [render_stereo_frames(scene, CAM, p) for p in paths]
    mt = MultiTracker.uniform(TrackerConfig(cam=CAM, orb=ORBConfig(n_features=500), **KW), 2,
                              device="cpu")
    calls = []
    fast, gather, sgather = torb.fast_nms_pyramid, torb.gather_patches, tstereo.gather_patches
    n = {"fast": 0, "gather": 0}

    def count(name, fn):
        def wrapped(*a, **k):
            n[name] += 1
            return fn(*a, **k)
        return wrapped

    torb.fast_nms_pyramid = count("fast", fast)
    torb.gather_patches = count("gather", gather)
    tstereo.gather_patches = count("gather", sgather)
    try:
        outs = []
        for i in range(N_STEREO):
            before = dict(n)
            outs.append(mt.track_stereo(torch.stack([f[i][0] for f in frames]),
                                        torch.stack([f[i][1] for f in frames]), i))
            calls.append({k: n[k] - before[k] for k in n})
    finally:
        torb.fast_nms_pyramid, torb.gather_patches, tstereo.gather_patches = fast, gather, sgather
    return mt, frames, outs, calls


def test_stereo_streams_share_one_extraction(stereo_multi):
    mt, _, outs, calls = stereo_multi
    assert all(c == {"fast": 1, "gather": 1 + mt.n_streams} for c in calls), calls
    assert all(o is not None for out in outs for o in out)
    assert all(t.state == TrackingState.OK and t._depth_mode for t in mt.trackers)


def test_stereo_streams_equal_their_own_systems(stereo_multi):
    mt, frames, _, _ = stereo_multi
    for b, tr in enumerate(mt.trackers):
        system = System(CAM, SensorType.STEREO, orb=ORBConfig(n_features=500), device="cpu", **KW)
        depth_session(system, frames[b])
        ref = system.tracker.export_trajectory()
        got = tr.export_trajectory()
        assert [x[0] for x in got] == [x[0] for x in ref] == list(range(N_STEREO))
        for (_, R, t, lost), (_, Rr, tr_, lr) in zip(got, ref):
            assert lost == lr
            np.testing.assert_allclose(R, Rr, rtol=0, atol=1e-6)
            np.testing.assert_allclose(t, tr_, rtol=0, atol=1e-6)
        assert tr._n_kf_host == system.tracker._n_kf_host


def test_stereo_streams_match_the_jax_multitracker(stereo_multi):
    mt, frames, _, _ = stereo_multi
    jcfg = JTrackerConfig(cam=JCamera(**CAM._asdict()), orb=JORBConfig(n_features=500), **KW)
    jmt = JMultiTracker.uniform(jcfg, 2)
    for i in range(N_STEREO):
        jmt.track_stereo(jnp.asarray(np.stack([f[i][0].numpy() for f in frames])),
                         jnp.asarray(np.stack([f[i][1].numpy() for f in frames])), i)
    for tr, jtr in zip(mt.trackers, jmt.trackers):
        c, jc = centres(tr.export_trajectory()), centres(jtr.export_trajectory())
        assert set(c) == set(jc) == set(range(N_STEREO))
        first_kf = int(tr.map.kf_frame_id[1])
        assert first_kf == int(jtr.map.kf_frame_id[1]) >= 3
        assert max(np.linalg.norm(c[k] - jc[k]) for k in range(first_kf)) < 1e-4
        assert max(np.linalg.norm(c[k] - jc[k]) for k in c) < 0.03


def test_mono_streams_initialize_apart_then_batch():
    scene = StepWallScene(np.random.default_rng(11))
    paths = [orbit_trajectory(N_MONO, step=0.045), orbit_trajectory(N_MONO, step=0.045, x0=-0.3)]
    frames = [render_frames(scene, CAM._replace(bf=0.0), p) for p in paths]
    mt = MultiTracker.uniform(TrackerConfig(cam=CAM._replace(bf=0.0), orb=ORBConfig(n_features=500),
                                            **KW), 2, device="cpu")
    for i in range(N_MONO):
        mt.track_monocular(torch.stack([f[i] for f in frames]), i)
    for b, tr in enumerate(mt.trackers):
        system = System(CAM._replace(bf=0.0), orb=ORBConfig(n_features=500), device="cpu", **KW)
        mono_session(system, frames[b])
        ref, got = system.tracker.export_trajectory(), tr.export_trajectory()
        assert tr.state == TrackingState.OK and len(got) == len(ref) >= N_MONO - 6, (b, len(got))
        for (f, R, t, _), (fr, Rr, tr_, _) in zip(got, ref):
            assert f == fr
            np.testing.assert_allclose(R, Rr, rtol=0, atol=1e-5)
            np.testing.assert_allclose(t, tr_, rtol=0, atol=1e-5)


def test_streams_must_share_one_orb_config():
    cfgs = [TrackerConfig(cam=CAM, orb=ORBConfig(n_features=n), **KW) for n in (500, 600)]
    with pytest.raises(ValueError, match="ORBConfig"):
        MultiTracker(cfgs, device="cpu")
    mt = MultiTracker.uniform(TrackerConfig(cam=CAM, **KW), 2, device="cpu")
    with pytest.raises(ValueError, match="3 images for 2 streams"):
        mt.track_stereo(torch.zeros(3, 240, 320), torch.zeros(3, 240, 320), 0)
