"""The port's viz modules against the JAX package's: the top-down map
render and the frame drawing pixel for pixel on a converted map, the live
viewer over real HTTP and through System.attach_viewer, plane detection
with the JAX picks replayed, and the AR cube."""

import json
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.mapstate import core as jax_core
from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.viz import ar as jax_ar
from tpuslam.viz import render as jax_render
from tpuslam_torch.convert import map_to_numpy
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.mapstate.core import make_empty_map
from tpuslam_torch.pipeline.system import SensorType, System
from tpuslam_torch.testing import build_loop_map
from tpuslam_torch.viz import ar, render
from tpuslam_torch.viz.server import LiveViewer

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def loop_map():
    """A 16-keyframe loop map (covisibility edges, 640 points), the port's
    and the same fields as the JAX package's MapState."""
    m, gt, _ = build_loop_map(np.random.default_rng(3), max_kf=20, max_pt=1000)
    jm = jax_core.MapState(*(jnp.asarray(x) for x in map_to_numpy(m)))
    return m, jm, gt


def _trajectory(gt):
    """(frame_id, R, t) rows as the System passes them: float64 poses."""
    return [(i, R.astype(np.float64), t.astype(np.float64)) for i, (R, t) in enumerate(gt)]


@pytest.mark.parametrize("with_traj", [False, True])
def test_render_map_topdown_equals_jax_pixel_for_pixel(loop_map, with_traj):
    """Without a trajectory the layout is float32, with one float64 (as
    numpy promotes it): both equal the JAX render pixel for pixel."""
    m, jm, gt = loop_map
    traj = _trajectory(gt) if with_traj else None
    got = np.asarray(render.render_map_topdown(m, traj, size=400))
    want = np.asarray(jax_render.render_map_topdown(jm, traj, size=400))
    assert got.shape == (400, 400, 3)
    assert (got != 255).any()
    np.testing.assert_array_equal(got, want)


def test_topdown_layout_edges_and_empty_map(loop_map):
    m, jm, _ = loop_map
    lay = render.topdown_layout(m, size=400)
    w = np.asarray(jax_core.covisibility_weights(jm))
    valid = np.asarray(jm.kf_valid)
    ii, jj = np.nonzero(np.triu(w[valid][:, valid], 1) >= 15)
    assert len(ii) > 10
    np.testing.assert_array_equal(lay.edges.numpy(), np.stack([ii, jj], -1))
    assert lay.points.shape == (int(m.pt_valid.sum()), 2) and lay.keyframes.shape == (16, 2)
    empty = render.topdown_layout(make_empty_map(4, 8, 16, "cpu"))
    assert all(len(x) == 0 for x in empty)
    blank = np.asarray(render.render_map_topdown(make_empty_map(4, 8, 16, "cpu"), size=50))
    assert (blank == 255).all()


def test_draw_frame_equals_jax_pixel_for_pixel(rng):
    img = rng.uniform(0, 255, (240, 320)).astype(np.float32)
    xy = rng.uniform(0, 320, (300, 2)).astype(np.float32) * np.array([1.0, 0.75], np.float32)
    valid = rng.uniform(size=300) < 0.8
    tracked = rng.uniform(size=300) < 0.5
    got = render.draw_frame(torch.from_numpy(img), torch.from_numpy(xy), torch.from_numpy(valid),
                            torch.from_numpy(tracked), state_text="OK | test")
    want = jax_render.draw_frame(img, xy, valid, tracked, state_text="OK | test")
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_live_viewer_http_roundtrip():
    """LiveViewer serves the page and a map snapshot over real HTTP."""
    m = make_empty_map(8, 16, 64, "cpu")
    pt_xyz, pt_valid, kf_valid = m.pt_xyz.clone(), m.pt_valid.clone(), m.kf_valid.clone()
    pt_xyz[:3] = torch.tensor([[0.0, 0, 2], [1, 0, 3], [0, 1, 4]])
    pt_valid[:3] = True
    kf_valid[0] = True
    m = m._replace(pt_xyz=pt_xyz, pt_valid=pt_valid, kf_valid=kf_valid, n_kf=torch.tensor(1))
    v = LiveViewer(port=0)  # an OS-assigned free port
    try:
        v.update(m, trajectory=[np.zeros(3), np.ones(3)], cam_R=np.eye(3), cam_t=np.zeros(3), status="OK")
        page = urllib.request.urlopen(f"http://127.0.0.1:{v.port}/", timeout=10).read()
        assert b"tpuslam live viewer" in page
        state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{v.port}/state", timeout=10).read())
        assert state["points"] == [[0.0, 0.0, 2.0], [1.0, 0.0, 3.0], [0.0, 1.0, 4.0]]
        assert state["kfs"] == [[0.0, 0.0, 0.0]] and len(state["traj"]) == 2
        assert state["cam"] is not None and state["status"] == "OK"
    finally:
        v.close()


def test_live_viewer_blob_equals_jax(loop_map):
    """The served JSON of one map, from the port's viewer and the JAX
    package's (max_points thins the points the same way)."""
    from tpuslam.viz.server import LiveViewer as JLiveViewer

    m, jm, gt = loop_map
    traj = [np.asarray(-R.T @ t) for R, t in gt[:5]]
    blobs = []
    for cls, mm in ((LiveViewer, m), (JLiveViewer, jm)):
        v = cls(port=0, max_points=200)
        try:
            v.update(mm, trajectory=traj, cam_R=gt[3][0], cam_t=gt[3][1], status="OK")
            blobs.append(json.loads(v._blob))
        finally:
            v.close()
    assert blobs[0] == blobs[1] and len(blobs[0]["points"]) <= 200


def test_system_attach_viewer():
    """System.attach_viewer publishes after tracked frames (a blank image:
    the state machine only), and shutdown closes it."""
    cam = PinholeCamera(fx=100.0, fy=100.0, cx=32.0, cy=32.0, width=64, height=64)
    system = System(cam, SensorType.MONOCULAR, device="cpu", max_keyframes=4, max_points=64)
    v = system.attach_viewer(port=0)
    system.track_monocular(np.zeros((64, 64), np.float32), 0.0)
    state = json.loads(urllib.request.urlopen(f"http://127.0.0.1:{v.port}/state", timeout=10).read())
    assert "frame=1" in state["status"] and state["status"].startswith("NOT_INITIALIZED")
    system.shutdown()
    assert system._viewer is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{v.port}/state", timeout=2)


def test_push_viewer_publishes_the_current_pose_and_the_trajectory():
    """The camera is the tracker's current pose; each trajectory row is
    composed with its reference keyframe's pose, lost rows skipped."""
    from tpuslam_torch.geometry.se3 import so3_exp

    cam = PinholeCamera(fx=100.0, fy=100.0, cx=32.0, cy=32.0, width=64, height=64)
    system = System(cam, SensorType.MONOCULAR, device="cpu", max_keyframes=4, max_points=64)
    tr = system.tracker
    rot = [so3_exp(torch.tensor(w)) for w in ([0.1, 0.2, 0.3], [0.0, 0.3, 0.0], [0.2, -0.1, 0.05])]
    tr._last_R, tr._last_t = rot[0], torch.tensor([0.5, -0.2, 1.0])
    kf_R, kf_t = tr.map.kf_R.clone(), tr.map.kf_t.clone()
    kf_R[1], kf_t[1] = rot[1], torch.tensor([0.3, 0.0, -0.4])
    tr.map = tr.map._replace(kf_R=kf_R, kf_t=kf_t)
    Rr, t_rel = rot[2].numpy().astype(np.float64), np.array([0.1, 0.2, 0.3])
    tr.trajectory = [(0, -1, Rr, t_rel, False), (1, 1, Rr, t_rel, False), (2, 1, np.eye(3), np.ones(3), True)]
    tr.n_frames = 3
    v = system.attach_viewer(viewer=LiveViewer(port=0))
    try:
        system._push_viewer()
        blob = json.loads(v._blob)
    finally:
        system.shutdown()
    R, t = tr._last_R.numpy(), tr._last_t.numpy()
    np.testing.assert_allclose(blob["cam"]["p"], -R.T @ t, atol=1e-4)
    Rw, tw = Rr @ kf_R[1].numpy(), Rr @ kf_t[1].numpy() + t_rel
    np.testing.assert_allclose(blob["traj"], [-Rr.T @ t_rel, -Rw.T @ tw], atol=1e-4)


def _plane_cloud(rng, n_in=200, n_out=50, n_invalid=30):
    """Points on z = 0.3x + 0.1y + 2 (+noise), uniform outliers, and invalid
    slots spread among them."""
    x = rng.uniform(-2, 2, n_in)
    y = rng.uniform(-2, 2, n_in)
    inl = np.stack([x, y, 0.3 * x + 0.1 * y + 2.0 + rng.normal(0, 0.005, n_in)], -1)
    out = rng.uniform(-3, 3, (n_out, 3)) + np.array([0, 0, 4.0])
    junk = rng.uniform(-50, 50, (n_invalid, 3))
    pts = np.concatenate([inl, out, junk]).astype(np.float32)
    valid = np.arange(len(pts)) < n_in + n_out
    perm = rng.permutation(len(pts))
    true_normal = np.array([0.3, 0.1, -1.0]) / np.linalg.norm([0.3, 0.1, -1.0])
    return pts[perm], valid[perm], true_normal


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_detect_plane_equals_jax_with_replayed_picks(rng, seed):
    pts, valid, n_true = _plane_cloud(rng)
    cam_center = np.array([0.0, 0.0, -5.0], np.float32)
    key = jax.random.PRNGKey(seed)
    want = jax_ar.detect_plane(key, jnp.asarray(pts), jnp.asarray(valid), jnp.asarray(cam_center))
    picks = torch.from_numpy(np.array(jax.random.randint(key, (50, 3), 0, max(int(valid.sum()), 3))))
    got = ar.detect_plane(torch.from_numpy(pts), torch.from_numpy(valid), cam_center, picks=picks)
    assert bool(got.success) == bool(want.success) is True
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.origin.numpy(), np.asarray(want.origin), atol=1e-5)
    cos = float(got.normal.numpy() @ np.asarray(want.normal))
    assert cos > np.cos(np.radians(0.01))
    assert abs(float(got.normal.numpy() @ n_true)) > 0.999
    assert float(got.normal @ (torch.from_numpy(cam_center) - got.origin)) > 0  # toward the camera


def test_detect_plane_draws_its_own_picks_and_fails_on_too_few_points(rng):
    pts, valid, n_true = _plane_cloud(rng)
    gen = torch.Generator().manual_seed(0)
    fit = ar.detect_plane(torch.from_numpy(pts), torch.from_numpy(valid), np.zeros(3), generator=gen)
    assert bool(fit.success) and abs(float(fit.normal.numpy() @ n_true)) > 0.999
    few = torch.zeros(len(pts), dtype=torch.bool)
    few[:20] = True
    assert not bool(ar.detect_plane(torch.from_numpy(pts), few, np.zeros(3), generator=gen).success)


def test_plane_frame_cube_and_overlay_equal_jax():
    cam = PinholeCamera(fx=300.0, fy=300.0, cx=160.0, cy=120.0, width=320, height=240)
    normal = np.array([0.3, 0.1, -1.0], np.float32)
    normal /= np.linalg.norm(normal)
    origin = np.array([0.1, -0.2, 3.0], np.float32)
    plane = ar.PlaneFit(torch.tensor(True), torch.from_numpy(normal), torch.from_numpy(origin),
                        torch.ones(1, dtype=torch.bool))
    jplane = jax_ar.PlaneFit(jnp.asarray(True), jnp.asarray(normal), jnp.asarray(origin), jnp.ones(1, bool))
    Rp = ar.plane_frame(torch.from_numpy(normal)).numpy()
    np.testing.assert_allclose(Rp.T @ Rp, np.eye(3), atol=1e-5)
    np.testing.assert_allclose(Rp, np.asarray(jax_ar.plane_frame(jnp.asarray(normal))), atol=1e-6)
    np.testing.assert_allclose(ar.cube_vertices(plane, 0.5), jax_ar.cube_vertices(jplane, 0.5), atol=1e-6)
    img = np.full((240, 320), 100.0, np.float32)
    R = np.eye(3, dtype=np.float32)
    t = np.array([0.05, 0.0, 0.2], np.float32)
    got = np.asarray(ar.draw_ar_cube(img, cam, R, t, plane, size=0.5))
    want = np.asarray(jax_ar.draw_ar_cube(img, JCamera(**cam._asdict()), R, t, jplane, size=0.5))
    assert ((got[..., 0] > 200) & (got[..., 1] < 100)).sum() > 50  # red wireframe pixels
    np.testing.assert_array_equal(got, want)
