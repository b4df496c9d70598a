"""The port's geometric solvers against the JAX package's on the CPU:
triangulation, two-view initialization, EPnP RANSAC, Horn's Sim3 and the
quaternion conversions.

The RANSAC draws cannot be reproduced in torch, so each test draws JAX's
hypothesis sets from its key (jax.random.randint, as the solvers do) and
passes them to the port as `picks`. eigh and svd may return other signs or
another candidate order, so the chosen motion is compared, never candidate
indices. Tolerances: triangulation 1e-4 relative; the chosen two-view
rotation 1e-4 and translation direction 1e-3, its inlier mask in >= 99% of
rows and its points 1e-3 relative. EPnP's control points follow the signs
of its principal directions, which the port fixes and LAPACK builds choose
freely (sfm/pnp.py), so PnP agrees to the noise of the estimate (0.5 px
on 100 points): rotation 3e-3, translation 1e-2 (3% of its norm), inliers
in >= 98% of rows, and both within test_sfm.py's bounds of the truth.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry import project as jproject, se3_apply as jse3_apply, se3_exp as jse3_exp
from tpuslam.geometry import so3_exp as jso3_exp
from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.geometry.se3 import quat_to_rotmat as jquat_to_rotmat, rotmat_to_quat as jrotmat_to_quat
from tpuslam.geometry.triangulation import triangulate_dlt as jtriangulate_dlt
from tpuslam.geometry.triangulation import triangulate_two_view as jtriangulate_two_view
from tpuslam.sfm import horn_sim3 as jhorn_sim3, initialize_two_view as jinit, pnp_ransac as jpnp
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.geometry.se3 import quat_to_rotmat, rotmat_to_quat
from tpuslam_torch.geometry.triangulation import triangulate_dlt, triangulate_two_view
from tpuslam_torch.sfm import horn_sim3, initialize_two_view, pnp_ransac
from tpuslam_torch.sfm.initializer import draw_picks

torch.set_num_threads(2)

JCAM = JCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
CAM = PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def jax_picks(key, n_hyp, size, valid):
    """The index sets jax.random.randint draws inside the JAX solvers."""
    n_valid = int(np.sum(valid))
    return np.asarray(jax.random.randint(key, (n_hyp, size), 0, max(n_valid, size)))


def rot_err_deg(R1, R2):
    c = (np.trace(np.asarray(R1, np.float64).T @ np.asarray(R2, np.float64)) - 1) / 2
    return np.rad2deg(np.arccos(np.clip(c, -1, 1)))


def project_pair(rng, X, xi2, noise, n_out=0):
    """test_sfm.py's pair of views: frame 1 at the origin, frame 2 at se3_exp(xi2)."""
    R2, t2 = jse3_exp(jnp.asarray(xi2))
    uv1 = np.array(jproject(JCAM, jnp.asarray(X)))
    uv2 = np.array(jproject(JCAM, jse3_apply(R2, t2, jnp.asarray(X))))
    uv1 += rng.normal(size=uv1.shape).astype(np.float32) * noise
    uv2 += rng.normal(size=uv2.shape).astype(np.float32) * noise
    if n_out:
        idx = rng.choice(len(X), n_out, replace=False)
        uv2[idx] += rng.uniform(30, 120, size=(n_out, 2)).astype(np.float32)
    return uv1, uv2, np.asarray(R2), np.asarray(t2)


def general_scene(rng, n=150, n_out=0):
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], -1).astype(np.float32)
    return X, project_pair(rng, X, np.array([0.02, -0.05, 0.01, 0.6, 0.05, 0.1], np.float32), 0.4, n_out)


def planar_scene(rng):
    X = np.stack([rng.uniform(-3, 3, 150), rng.uniform(-2, 2, 150), np.full(150, 6.0)], -1).astype(np.float32)
    X[:, 2] += rng.normal(size=150).astype(np.float32) * 0.01
    return X, project_pair(rng, X, np.array([0.03, -0.06, 0.02, 0.5, 0.1, 0.05], np.float32), 0.3)


def rotation_scene(rng):
    X = np.stack([rng.uniform(-3, 3, 150), rng.uniform(-2, 2, 150), rng.uniform(4, 12, 150)], -1).astype(np.float32)
    return X, project_pair(rng, X, np.array([0.02, -0.05, 0.03, 0.0, 0.0, 0.0], np.float32), 0.3)


def test_triangulate_dlt_matches_jax(rng):
    n = 200
    P1 = rng.normal(size=(n, 3, 4)).astype(np.float32)
    P2 = rng.normal(size=(n, 3, 4)).astype(np.float32)
    uv1 = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    uv2 = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    jX, jw = jtriangulate_dlt(*(jnp.asarray(a) for a in (P1, P2, uv1, uv2)))
    X, w = triangulate_dlt(t(P1), t(P2), t(uv1), t(uv2))
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-6)
    ok = np.abs(np.asarray(jw)) > 1e-3  # conditioned systems
    np.testing.assert_allclose(X.numpy()[ok], np.asarray(jX)[ok], rtol=1e-4, atol=1e-4)


def test_triangulate_two_view_matches_jax(rng):
    X, (uv1, uv2, R2, t2) = general_scene(rng)
    R1, t1 = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    args = (R1, t1, R2, t2, np.asarray(JCAM.K), uv1, uv2)
    jX, jw = jtriangulate_two_view(*(jnp.asarray(a) for a in args))
    Xp, w = triangulate_two_view(*(t(a) for a in args))
    np.testing.assert_allclose(Xp.numpy(), np.asarray(jX), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), rtol=1e-4, atol=1e-7)
    assert np.median(np.linalg.norm(Xp.numpy() - X, axis=-1)) < 0.2  # the scene itself


def _run_init(uv1, uv2, seed):
    valid = np.ones(len(uv1), bool)
    key = jax.random.PRNGKey(seed)
    ref = jinit(key, JCAM.K, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid))
    got = initialize_two_view(CAM.K, t(uv1), t(uv2), t(valid), picks=t(jax_picks(key, 200, 8, valid)))
    return ref, got


@pytest.mark.parametrize("scene, seed, is_h", [(general_scene, 0, False), (planar_scene, 1, True)])
def test_initialize_two_view_matches_jax(rng, scene, seed, is_h):
    """The general scene takes F, the planar one H; with JAX's hypothesis
    sets both sides choose the same motion and triangulate the same points."""
    X, (uv1, uv2, R_gt, t_gt) = scene(rng)
    ref, got = _run_init(uv1, uv2, seed)
    assert bool(got.success) and bool(ref.success)
    assert bool(got.is_h) == bool(ref.is_h) == is_h
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    inl, jinl = got.inliers.numpy(), np.asarray(ref.inliers)
    assert (inl == jinl).mean() >= 0.99 and inl.sum() > 100
    both = inl & jinl
    np.testing.assert_allclose(got.points.numpy()[both], np.asarray(ref.points)[both], rtol=1e-3, atol=1e-3)
    assert abs(int(got.n_good) - int(ref.n_good)) <= 0.01 * int(ref.n_good)
    assert rot_err_deg(got.R.numpy(), R_gt) < 1.5


def test_initialize_two_view_rejects_pure_rotation(rng):
    _, (uv1, uv2, _, _) = rotation_scene(rng)
    ref, got = _run_init(uv1, uv2, 2)
    assert not bool(ref.success) and not bool(got.success)


def test_initialize_two_view_with_outliers_and_invalid_rows(rng):
    """30 outliers and 20 rows marked invalid (their picks skip them)."""
    X, (uv1, uv2, R_gt, t_gt) = general_scene(rng, 200, n_out=30)
    valid = np.ones(200, bool)
    valid[rng.choice(200, 20, replace=False)] = False
    key = jax.random.PRNGKey(3)
    ref = jinit(key, JCAM.K, jnp.asarray(uv1), jnp.asarray(uv2), jnp.asarray(valid))
    got = initialize_two_view(CAM.K, t(uv1), t(uv2), t(valid), picks=t(jax_picks(key, 200, 8, valid)))
    assert bool(got.success) and bool(ref.success) and not bool(got.is_h)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-3)
    assert (got.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.99
    assert not got.inliers.numpy()[~valid].any()


def test_initialize_two_view_draws_its_own_hypotheses(rng):
    """Without picks the generator draws them: the same seed, the same result."""
    _, (uv1, uv2, R_gt, _) = general_scene(rng)
    valid = torch.ones(len(uv1), dtype=torch.bool)
    a = initialize_two_view(CAM.K, t(uv1), t(uv2), valid, generator=torch.Generator().manual_seed(7))
    b = initialize_two_view(CAM.K, t(uv1), t(uv2), valid, generator=torch.Generator().manual_seed(7))
    assert bool(a.success) and torch.equal(a.R, b.R) and torch.equal(a.inliers, b.inliers)
    assert rot_err_deg(a.R.numpy(), R_gt) < 1.0
    picks = draw_picks(200, 8, valid, torch.Generator().manual_seed(7))
    assert picks.shape == (200, 8) and int(picks.min()) >= 0 and int(picks.max()) < len(uv1)


def _pnp_problem(rng, n, xi, n_out=0):
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(4, 10, n)], -1).astype(np.float32)
    R_gt, t_gt = jse3_exp(jnp.asarray(xi))
    uv = np.array(jproject(JCAM, jse3_apply(R_gt, t_gt, jnp.asarray(X))))
    uv += rng.normal(size=uv.shape).astype(np.float32) * 0.5
    out = rng.choice(n, n_out, replace=False) if n_out else np.zeros(0, int)
    uv[out] += rng.uniform(25, 100, size=(len(out), 2)).astype(np.float32)
    return X, uv, np.asarray(R_gt), np.asarray(t_gt), out


@pytest.mark.parametrize("n_out", [0, 30])
def test_pnp_ransac_matches_jax(rng, n_out):
    X, uv, R_gt, t_gt, out = _pnp_problem(rng, 100, [0.1, 0.2, -0.1, 0.3, 0.1, -0.2], n_out)
    valid = np.ones(100, bool)
    inv_s2 = rng.choice([1.0, 1 / 1.44, 1 / 2.0736], 100).astype(np.float32)
    key = jax.random.PRNGKey(1)
    ref = jpnp(key, JCAM.K, jnp.asarray(X), jnp.asarray(uv), jnp.asarray(inv_s2), jnp.asarray(valid))
    got = pnp_ransac(CAM.K, t(X), t(uv), t(inv_s2), t(valid), picks=t(jax_picks(key, 128, 4, valid)))
    assert bool(got.success) and bool(ref.success)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=3e-3)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-2)
    assert (got.inliers.numpy() == np.asarray(ref.inliers)).mean() >= 0.98
    assert abs(int(got.n_inliers) - int(ref.n_inliers)) <= 2
    assert rot_err_deg(got.R.numpy(), R_gt) < 1.0 and np.linalg.norm(got.t.numpy() - t_gt) < 0.1
    if n_out:
        assert got.inliers.numpy()[out].mean() < 0.2


def test_pnp_ransac_too_few_points_fails_like_jax(rng):
    n = 20
    X = rng.uniform(-2, 2, (n, 3)).astype(np.float32) + [0, 0, 6]
    uv = rng.uniform(0, 640, (n, 2)).astype(np.float32)
    valid = np.zeros(n, bool)
    valid[:5] = True
    key = jax.random.PRNGKey(2)
    ref = jpnp(key, JCAM.K, jnp.asarray(X), jnp.asarray(uv), jnp.ones(n), jnp.asarray(valid))
    got = pnp_ransac(CAM.K, t(X), t(uv), torch.ones(n), t(valid), picks=t(jax_picks(key, 128, 4, valid)))
    assert not bool(ref.success) and not bool(got.success)
    assert int(got.n_inliers) == int(ref.n_inliers)
    assert not got.inliers.numpy()[~valid].any()


@pytest.mark.parametrize("fix_scale", [False, True])
def test_horn_sim3_matches_jax(rng, fix_scale):
    n = 30
    P1 = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    R_gt = np.asarray(jso3_exp(jnp.asarray(np.array([0.3, -0.2, 0.5], np.float32))))
    P2 = (1.0 if fix_scale else 1.7) * P1 @ R_gt.T + np.array([0.4, -1.0, 2.0], np.float32)
    P2 += rng.normal(size=P2.shape).astype(np.float32) * 0.01
    w = rng.uniform(0.5, 1.0, n).astype(np.float32)
    js, jR, jt = jhorn_sim3(jnp.asarray(P1), jnp.asarray(P2), jnp.asarray(w), fix_scale=fix_scale)
    s, R, tt = horn_sim3(t(P1), t(P2), t(w), fix_scale=fix_scale)
    assert abs(float(s) - float(js)) < 1e-5
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-4)
    if fix_scale:
        assert float(s) == 1.0


def test_quaternions_match_jax(rng):
    """Rotations near each of Shepperd's four branches, and back."""
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:4] = [[0.0, 0.0, 0.0], [np.pi - 1e-3, 0, 0], [0, np.pi - 1e-3, 0], [0, 0, np.pi - 1e-3]]
    R = np.asarray(jso3_exp(jnp.asarray(w)))
    jq = np.asarray(jrotmat_to_quat(jnp.asarray(R)))
    q = rotmat_to_quat(t(R)).numpy()
    np.testing.assert_allclose(q, jq, atol=1e-6)
    assert (q[:, 3] >= 0).all()
    np.testing.assert_allclose(quat_to_rotmat(t(q)).numpy(), np.asarray(jquat_to_rotmat(jnp.asarray(jq))),
                               atol=1e-6)
    np.testing.assert_allclose(quat_to_rotmat(t(q)).numpy(), R, atol=1e-5)
