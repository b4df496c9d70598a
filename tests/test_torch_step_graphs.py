"""The frame step's segments and StepGraphs (pipeline/graphs.py), on the
CPU at the fixture size of test_torch_track_map.py (320x240, 300
features, K=8 keyframes, 600 keypoint slots, P=4096 points), and on a
card.

- The segments composed as the Tracker composes them (through StepGraphs'
  static buffers) equal the eager fused_track_frame bit for bit in each
  branch: no velocity; the motion model accepted at th=7; the th=14 retry;
  the reference keyframe after a failed motion model. They match the JAX
  fused_track_frame within the tolerances of test_torch_track_map.py
  (poses 1e-3; integers and masks exact).
- Each track segment runs on meta tensors, which raise at a device->host
  read, with every host<->device copy refused: a segment reads nothing
  back and copies nothing in, so a card can capture it. It modifies none
  of its inputs.
- The buffer protocol on the CPU: a frame's outputs survive the next run;
  a map replaced between frames, or changed in place, is the map the next
  run reads.
- On a card (`cuda`): a 14-frame mono session through the graphs equals
  the same session run eagerly (torch.equal); a capture forced to fail
  raises, and nothing runs eagerly in its place.

This module imports no jax at its top (the JAX comparison imports it), so
its card tests run on a machine without it:
    python -m pytest --noconftest tests/test_torch_step_graphs.py -m cuda
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpuslam_torch.convert import frame_features_to_numpy, map_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.geometry.se3 import se3_exp
from tpuslam_torch.ops.orb import ORBConfig, extract_orb
from tpuslam_torch.pipeline import steps
from tpuslam_torch.pipeline.graphs import StepGraphs
from tpuslam_torch.testing import (
    StepWallScene,
    build_depth_session,
    orb_frame_features,
    orbit_trajectory,
)

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
CAM = PinholeCamera(fx=250.0, fy=250.0, cx=160.0, cy=120.0, width=320, height=240)
CFG = ORBConfig(n_features=300)
K, N_CAP, P = 8, 600, 4096
SNAP = 8  # frame 8 has a velocity
INT_FIELDS = [steps.FUSED_ACCEPT, steps.FUSED_INITIAL_OK, steps.FUSED_USED_MM,
              steps.FUSED_N_TRACKED, *range(steps.FUSED_GATES, steps.FUSED_GATES + 4),
              steps.FUSED_NM]
# Each branch: the yaw (deg) added to the session's velocity (None: no
# velocity) and the segments the host runs. 8 deg leaves the th=7 window
# short of 20 matches with 10 map inliers and the th=14 window well above;
# at 12 deg both fail and the reference keyframe tracks.
BRANCHES = {
    "no_velocity": (None, ["ref", "local"]),
    "motion_model": (0.0, ["mm", "local"]),
    "retry": (8.0, ["mm", "mm", "local"]),
    "fallback": (12.0, ["mm", "mm", "ref", "local"]),
}


@pytest.fixture(scope="module")
def session():
    scene = StepWallScene(np.random.default_rng(5))
    poses = orbit_trajectory(SNAP + 1, step=0.02, x0=-0.5, yaw_rate=0.002)
    s = build_depth_session(scene, CAM, CFG, poses, K, N_CAP, P, kf_every=3, snapshot_at=(SNAP,))
    st, img = s.snapshots[SNAP]
    return s, st, orb_frame_features(extract_orb(img, CFG))


def _velocity(st, yaw_deg):
    if yaw_deg is None:
        return torch.eye(3), torch.zeros(3), False
    w = torch.zeros(6)
    w[1] = float(np.deg2rad(yaw_deg))
    return se3_exp(w)[0] @ st.vel_R, st.vel_t, True


def _compose(run, s, st, feats, branch, m=None):
    """The step as the Tracker composes it, each segment through `run`."""
    vel_R, vel_t, has_vel = _velocity(st, BRANCHES[branch][0])
    return steps.compose_track_frame(
        run, CAM, st.m if m is None else m, st.last_feats, st.last_obs, st.last_R, st.last_t,
        vel_R, vel_t, has_vel, feats, st.ref_kf, s.inv_sigma2, 0.0, 30.0, CFG.scale_factor,
        CFG.n_levels, 10, False, 0, 0)


def _eager(s, st, feats, branch, m=None):
    vel_R, vel_t, has_vel = _velocity(st, BRANCHES[branch][0])
    return steps.fused_track_frame(
        CAM, st.m if m is None else m, st.last_feats, st.last_obs, st.last_R, st.last_t,
        vel_R, vel_t, has_vel, feats, st.ref_kf, s.inv_sigma2, 0.0, 30.0)


def _jax_step(s, st, feats, branch):
    import jax.numpy as jnp

    from tpuslam.geometry.camera import PinholeCamera as JCamera
    from tpuslam.mapstate import core as jcore
    from tpuslam.pipeline import steps as jsteps

    vel_R, vel_t, has_vel = _velocity(st, BRANCHES[branch][0])
    ff = lambda f: jcore.FrameFeatures(*(jnp.asarray(x) for x in frame_features_to_numpy(f)))  # noqa: E731
    out = jsteps.fused_track_frame(
        JCamera(**CAM._asdict()), jcore.MapState(*(jnp.asarray(x) for x in map_to_numpy(st.m))),
        ff(st.last_feats), jnp.asarray(st.last_obs.numpy()), jnp.asarray(st.last_R.numpy()),
        jnp.asarray(st.last_t.numpy()), jnp.asarray(vel_R.numpy()), jnp.asarray(vel_t.numpy()),
        jnp.asarray(has_vel), ff(feats), jnp.int32(st.ref_kf), jnp.asarray(s.inv_sigma2.numpy()),
        jnp.float32(0.0), jnp.float32(30.0))
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("branch", list(BRANCHES))
def test_segments_equal_the_eager_step_and_match_jax(session, branch):
    s, st, feats = session
    graphs = StepGraphs("cpu")
    ran = []

    def run(name, fn, static, **inputs):
        ran.append(name)
        return graphs.run(name, fn, static, **inputs)

    got = [x.numpy() for x in _compose(run, s, st, feats, branch)]
    eager = [x.numpy() for x in _eager(s, st, feats, branch)]
    assert ran == BRANCHES[branch][1]
    for a, b in zip(got, eager):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    p = got[-1]
    assert p[steps.FUSED_ACCEPT] == 1 and p[steps.FUSED_USED_MM] == float(branch in ("motion_model", "retry"))

    ref = _jax_step(s, st, feats, branch)
    (jR, jt, jobs, jvR, jvt, jvis, jfound, jp), (R, t, obs, vR, vt, vis, found, p) = ref, got
    np.testing.assert_array_equal(p[INT_FIELDS], jp[INT_FIELDS])
    np.testing.assert_array_equal(obs, jobs)
    np.testing.assert_array_equal(vis, jvis)
    np.testing.assert_array_equal(found, jfound)
    for a, b in ((R, jR), (t, jt), (vR, jvR), (vt, jvt), (p, jp)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3)


class _NoHostTraffic(TorchDispatchMode):
    """Refuses any copy between the host and the device."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in (torch.ops.aten._to_copy.default, torch.ops.aten.copy_.default):
            devs = {a.device.type for a in args if isinstance(a, torch.Tensor)}
            if isinstance(out, torch.Tensor):
                devs.add(out.device.type)
            if len(devs) > 1:
                raise AssertionError(f"{func} moves data between {sorted(devs)}")
        return out


def _segment_inputs(s, st, feats):
    """Each track segment's (fn, static, inputs) at the session's state."""
    ref = torch.full((1,), st.ref_kf, dtype=torch.int64)
    mm_static = dict(cam=CAM, th=7.0, scale_factor=CFG.scale_factor, n_levels=CFG.n_levels,
                     min_inliers_motion=10)
    local_static = dict(cam=CAM, th_depth=0.0, scale_factor=CFG.scale_factor, n_levels=CFG.n_levels,
                        depth=False, max_local_pts=256, cand_cap=128)
    return {
        "mm": (steps.mm_segment, mm_static, dict(
            m=steps.map_fields(st.m, steps.MM_MAP_FIELDS), last_feats=st.last_feats,
            last_obs=st.last_obs, last_R=st.last_R, last_t=st.last_t, vel_R=st.vel_R,
            vel_t=st.vel_t, feats=feats, inv_sigma2_table=s.inv_sigma2)),
        "ref": (steps.ref_segment, dict(cam=CAM), dict(
            m=steps.map_fields(st.m, steps.REF_MAP_FIELDS), ref_kf=ref, feats=feats,
            last_R=st.last_R, last_t=st.last_t, inv_sigma2_table=s.inv_sigma2)),
        "local": (steps.local_segment, local_static, dict(
            m=steps.map_fields(st.m, steps.LOCAL_MAP_FIELDS), ref_kf=ref, feats=feats,
            R0=st.last_R, t0=st.last_t, obs0=torch.full((feats.xy.shape[0],), -1, dtype=torch.int32),
            last_R=st.last_R, last_t=st.last_t, initial_ok=torch.ones((), dtype=torch.bool),
            mm_ok=torch.zeros((), dtype=torch.bool), n_mm=torch.zeros((), dtype=torch.int64),
            accept_thr=torch.full((1,), 30.0), inv_sigma2_table=s.inv_sigma2)),
    }


def _on(tree, make):
    """tree with every tensor replaced by make(tensor)."""
    if isinstance(tree, torch.Tensor):
        return make(tree)
    if isinstance(tree, tuple):
        vals = [_on(x, make) for x in tree]
        return type(tree)(*vals) if hasattr(tree, "_fields") else tuple(vals)
    return tree


def _host_data_refused(make):
    """torch.tensor / torch.as_tensor that refuse host data for a device:
    on a card they copy it in (a meta tensor takes no copy to catch)."""

    def made(data, *args, device=None, **kwargs):
        if device is not None and torch.device(device).type != "cpu":
            raise AssertionError(f"host data copied to {device}")
        return make(data, *args, **kwargs)

    return made


@pytest.mark.parametrize("segment", ["mm", "ref", "local"])
def test_track_segment_makes_no_host_read_or_copy(session, segment, monkeypatch):
    """On meta tensors (shapes without data, a device of their own):
    .item(), bool() and .cpu() raise, a host tensor mixed in raises, and
    _NoHostTraffic refuses any copy between the host and the device, as do
    torch.tensor and torch.as_tensor with a device. The local segment runs
    the large-map regime (the local subset and the candidate block)."""
    s, st, feats = session
    monkeypatch.setattr(torch, "tensor", _host_data_refused(torch.tensor))
    monkeypatch.setattr(torch, "as_tensor", _host_data_refused(torch.as_tensor))
    fn, static, inputs = _segment_inputs(s, st, feats)[segment]
    meta = {k: _on(v, lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"))
            for k, v in inputs.items()}
    leaves = []
    for v in meta.values():
        _on(v, lambda t: leaves.append(t) or t)
    versions = [t._version for t in leaves]
    with _NoHostTraffic():
        out = fn(**meta, **static)
    assert all(o.device.type == "meta" for o in out)
    assert [t._version for t in leaves] == versions  # no input modified


def test_a_frame_outputs_survive_the_next_run(session):
    """Frame k's outputs are the caller's own: frame k+1 through the same
    buffers leaves them as they were."""
    s, st, feats = session
    graphs = StepGraphs("cpu")
    first = _compose(graphs.run, s, st, feats, "motion_model")
    kept = [x.clone() for x in first]
    _compose(graphs.run, s, st, feats, "fallback")
    for a, b in zip(first, kept):
        assert torch.equal(a, b)


def test_a_replaced_or_changed_map_is_the_map_the_next_run_reads(session):
    """A keyframe replaces the map's tensors (the next run copies the new
    ones in); an in-place change of one (its _version moves) is copied in
    too. Each run equals the eager step on the map it was given."""
    s, st, feats = session
    graphs = StepGraphs("cpu")
    _compose(graphs.run, s, st, feats, "no_velocity")
    m2 = st.m._replace(pt_valid=st.m.pt_valid & (torch.arange(P) % 2 == 0),
                       pt_visible=st.m.pt_visible + 1.0)
    got = _compose(graphs.run, s, st, feats, "no_velocity", m=m2)
    for a, b in zip(got, _eager(s, st, feats, "no_velocity", m=m2)):
        assert torch.equal(a, b)
    m3 = m2._replace(pt_xyz=m2.pt_xyz.clone())
    stale = _compose(graphs.run, s, st, feats, "no_velocity", m=m3)
    m3.pt_xyz[::4] += 0.5  # in place: the same tensor, a new _version
    got = _compose(graphs.run, s, st, feats, "no_velocity", m=m3)
    for a, b in zip(got, _eager(s, st, feats, "no_velocity", m=m3)):
        assert torch.equal(a, b)
    assert not torch.equal(got[-1], stale[-1])


@pytest.mark.cuda
def test_graphed_mono_session_equals_eager_on_card():
    """The 14-frame monocular session of test_torch_package.py on the card,
    once through the tracker's graphs and once with every segment run
    eagerly: every pose, keyframe and map tensor equal (torch.equal), and
    every steady-state frame replayed."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpuslam_torch.pipeline.system import System
    from tpuslam_torch.testing import mono_session, render_frames

    cam = PinholeCamera(fx=350.0, fy=350.0, cx=160.0, cy=120.0, width=320, height=240)
    frames = render_frames(StepWallScene(np.random.default_rng(11)), cam, orbit_trajectory(14, step=0.045))
    runs = []
    for graphed in (True, False):
        system = System(cam, orb=ORBConfig(n_features=500), device="cuda", max_keyframes=16,
                        max_points=4096, kf_max_frames=10, enable_loop_closing=False)
        if not graphed:
            system.tracker.graphs.run = steps.call_segment
        res = mono_session(system, [f.cuda() for f in frames])
        runs.append((system.tracker, [out for out, _ in res]))
    (a, out_a), (b, out_b) = runs
    assert a.stats["graph_replays"] == a.stats["dispatches"] > 0 and a.stats["graph_captures"] >= 3
    assert b.stats["graph_replays"] == 0
    assert a._n_kf_host == b._n_kf_host
    for x, y in zip(out_a, out_b):
        assert (x is None) == (y is None)
        if x is not None:
            assert np.array_equal(x[0], y[0]) and np.array_equal(x[1], y[1])
    for name, x in a.map._asdict().items():
        assert torch.equal(x, getattr(b.map, name)), name


@pytest.mark.cuda
def test_failed_capture_raises_on_card():
    """A segment that reads the device cannot be captured: StepGraphs.run
    raises, and runs nothing in its place (a child process: a failed
    capture may leave the CUDA context unusable)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    code = (
        "import torch\n"
        "from tpuslam_torch.pipeline.graphs import StepGraphs\n"
        "calls = []\n"
        "def seg(x):\n"
        "    calls.append(1)\n"
        "    return x * 2 if bool((x > 0).all()) else x\n"
        "g = StepGraphs('cuda')\n"
        "try:\n"
        "    g.run('bad', seg, {}, x=torch.ones(4, device='cuda'))\n"
        "except Exception as e:\n"
        "    print('raised', type(e).__name__, 'calls', len(calls), 'captures', g.captures, 'replays', g.replays)\n"
        "else:\n"
        "    print('no raise')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    # The warm-up call and the capture's call; no third, eager one.
    assert "raised" in out.stdout and "calls 2 captures 0 replays 0" in out.stdout, out.stdout + out.stderr
