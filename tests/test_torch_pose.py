"""The port's geometry and pose optimization against the JAX package, on
the CPU. Float32 sums run in another order in the two frameworks, hence the
tolerances: 1e-5 for closed-form geometry, 1e-4 for the 6x6 solve, 1e-3 for
the 40-iteration LM result."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuslam.geometry.camera as jcam
import tpuslam.geometry.se3 as jse3
from tpuslam.optim.linalg import solve_spd as jax_solve_spd
from tpuslam.optim.pose import PoseObs as JaxPoseObs
from tpuslam.optim.pose import pose_optimization as jax_pose_optimization
from tpuslam.pipeline.steps import predict_scale as jax_predict_scale
import tpuslam_torch.geometry.camera as tcam
import tpuslam_torch.geometry.se3 as tse3
from tpuslam_torch.convert import array_to_tensor, camera_from, pose_obs_to_torch
from tpuslam_torch.optim.linalg import solve_spd
from tpuslam_torch.optim.pose import pose_optimization
from tpuslam_torch.pipeline.steps import predict_scale

torch.set_num_threads(2)

JCAM = jcam.PinholeCamera(fx=500.0, fy=480.0, cx=320.0, cy=240.0,
                          k1=0.1, k2=-0.05, p1=0.001, p2=-0.002, k3=0.01)


def _t(x):
    return torch.from_numpy(np.array(x, np.float32))


# Rotations of ~1 and ~0.1 rad, and on the Taylor branch (theta^2 < 1e-8)
# down to 0. Not ~1e-3 rad: there the float32 closed forms of the JAX
# package cancel (1 - cos t, t - sin t), and one libm ulp of cos or sin moves
# t by ~5e-5 in either framework.
@pytest.mark.parametrize("scale", [1.0, 0.1, 1e-5, 0.0])
def test_se3_functions(rng, scale):
    w = (rng.normal(size=(5, 3)) * scale).astype(np.float32)
    xi = np.concatenate([w, rng.normal(size=(5, 3))], -1).astype(np.float32)
    x = rng.normal(size=(5, 3)).astype(np.float32)

    def close(got, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0, atol=1e-5)

    close(tse3.hat(_t(w)), jse3.hat(jnp.asarray(w)))
    close(tse3.so3_exp(_t(w)), jse3.so3_exp(jnp.asarray(w)))
    # The factors alone, at angles where float32 closed forms are well
    # conditioned, and on the Taylor branch.
    tsq = np.array([4.0, 1.0, 0.25, 1e-9, 1e-12, 0.0], np.float32)
    for a, b in zip(tse3._sinc_factors(_t(tsq)), jse3._sinc_factors(jnp.asarray(tsq))):
        close(a, b)
    R, t = tse3.se3_exp(_t(xi))
    jR, jt = jse3.se3_exp(jnp.asarray(xi))
    close(R, jR)
    close(t, jt)
    R2, t2 = tse3.se3_exp(_t(xi[::-1].copy()))
    jR2, jt2 = jse3.se3_exp(jnp.asarray(xi[::-1].copy()))
    for g, r in zip(tse3.se3_compose(R, t, R2, t2), jse3.se3_compose(jR, jt, jR2, jt2)):
        close(g, r)
    for g, r in zip(tse3.se3_inverse(R, t), jse3.se3_inverse(jR, jt)):
        close(g, r)
    close(tse3.se3_apply(R, t, _t(x)), jse3.se3_apply(jR, jt, jnp.asarray(x)))
    noisy = np.asarray(jR) + rng.normal(0, 1e-3, (5, 3, 3)).astype(np.float32)
    close(tse3.so3_project(_t(noisy)), jse3.so3_project(jnp.asarray(noisy)))


def test_camera_project_and_undistort(rng):
    cam = camera_from(JCAM)
    assert isinstance(cam, tcam.PinholeCamera) and cam.k1 == 0.1
    p = np.stack([rng.uniform(-2, 2, 50), rng.uniform(-1, 1, 50), rng.uniform(1, 8, 50)], -1)
    uv = np.stack([rng.uniform(0, 640, 50), rng.uniform(0, 480, 50)], -1).astype(np.float32)
    np.testing.assert_allclose(
        tcam.project(cam, _t(p)).numpy(), np.asarray(jcam.project(JCAM, jnp.asarray(p, jnp.float32))),
        rtol=0, atol=1e-3,
    )
    np.testing.assert_allclose(
        tcam.undistort_points(cam, _t(uv)).numpy(),
        np.asarray(jcam.undistort_points(JCAM, jnp.asarray(uv))), rtol=0, atol=1e-3,
    )


def test_solve_spd(rng):
    A = rng.normal(size=(7, 6, 6)).astype(np.float32)
    H = (A @ np.swapaxes(A, -1, -2) + 0.5 * np.eye(6, dtype=np.float32)).astype(np.float32)
    b = rng.normal(size=(7, 6)).astype(np.float32)
    got = solve_spd(_t(H), _t(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_solve_spd(jnp.asarray(H), jnp.asarray(b))),
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(np.einsum("bij,bj->bi", H, got), b, rtol=0, atol=1e-3)


def test_predict_scale_exact(rng):
    dist = rng.uniform(0.5, 12, 200).astype(np.float32)
    max_d = (dist * rng.uniform(0.3, 5, 200)).astype(np.float32)
    np.testing.assert_array_equal(
        predict_scale(_t(dist), _t(max_d), 1.2, 8).numpy(),
        np.asarray(jax_predict_scale(jnp.asarray(dist), jnp.asarray(max_d), 1.2, 8)),
    )


def test_pose_optimization_batched(rng):
    """Three streams, each with noisy inliers, 20% gross outliers and some
    invalid edges, from a perturbed start."""
    B, N = 3, 200
    cam = tcam.PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    jc = jcam.PinholeCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0)
    w_true = rng.normal(0, 0.05, (B, 3)).astype(np.float32)
    xi_true = np.concatenate([w_true, rng.normal(0, 0.1, (B, 3))], -1).astype(np.float32)
    R_true, t_true = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi_true)))
    pts = np.stack([rng.uniform(-3, 3, (B, N)), rng.uniform(-2, 2, (B, N)),
                    rng.uniform(4, 10, (B, N))], -1).astype(np.float32)
    uv = np.asarray(jcam.project(jc, jse3.se3_apply(
        jnp.asarray(R_true)[:, None], jnp.asarray(t_true)[:, None], jnp.asarray(pts))))
    uv = uv + rng.normal(0, 1.0, uv.shape)
    outl = rng.uniform(size=(B, N)) < 0.2
    uv[outl] += rng.uniform(-80, 80, (int(outl.sum()), 2))
    level = rng.integers(0, 8, (B, N))
    obs = dict(
        pts_w=pts,
        uvr=np.concatenate([uv, -np.ones((B, N, 1))], -1).astype(np.float32),
        inv_sigma2=(1.0 / 1.44**level).astype(np.float32),
        valid=rng.uniform(size=(B, N)) < 0.95,
    )
    xi0 = xi_true + rng.normal(0, 0.02, xi_true.shape).astype(np.float32)
    R0, t0 = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi0)))

    jobs = JaxPoseObs(*(jnp.asarray(v) for v in obs.values()))
    jR, jt, jinl, jn = jax_pose_optimization(jc, jnp.asarray(R0), jnp.asarray(t0), jobs)
    R, t, inl, n = pose_optimization(cam, _t(R0), _t(t0), pose_obs_to_torch(jobs, "cpu"))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), rtol=0, atol=1e-3)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), rtol=0, atol=1e-3)
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    np.testing.assert_array_equal(n.numpy(), np.asarray(jn))
    np.testing.assert_allclose(t.numpy(), t_true, rtol=0, atol=0.05)
    assert (n.numpy() > 0.6 * N).all()
