"""The port's Sim(3) geometry and loop-closing Sim3 solvers against the JAX
package's on the CPU: so3_log / se3_log in their three regimes, the sim3
group functions, the mutual chi2 inlier test, the Sim3 RANSAC with JAX's
hypothesis sets replayed, and the Gauss-Newton refinement.

Tolerances: so3_log / se3_log 1e-5 (absolute, on O(1) values); the sim3
functions 1e-5; sim3_chi2_inliers exact; sim3_ransac the same inlier mask
and s, R, t within 1e-4; optimize_sim3 s, R, t within 1e-4 relative and the
same inliers.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry.se3 import se3_log as jse3_log, so3_exp as jso3_exp, so3_log as jso3_log
from tpuslam.geometry.sim3 import (
    sim3_apply as jsim3_apply,
    sim3_compose as jsim3_compose,
    sim3_exp as jsim3_exp,
    sim3_inverse as jsim3_inverse,
    sim3_log as jsim3_log,
)
from tpuslam.sfm.sim3solver import (
    optimize_sim3 as joptimize_sim3,
    sim3_chi2_inliers as jsim3_chi2_inliers,
    sim3_ransac as jsim3_ransac,
)
from tpuslam_torch.geometry.se3 import se3_log, so3_exp, so3_log
from tpuslam_torch.geometry.sim3 import sim3_apply, sim3_compose, sim3_exp, sim3_inverse, sim3_log
from tpuslam_torch.sfm.sim3solver import optimize_sim3, sim3_chi2_inliers, sim3_ransac

torch.set_num_threads(2)

K = np.array([[500.0, 0, 320.0], [0, 500.0, 240.0], [0, 0, 1]], np.float32)


def t(x):
    return torch.from_numpy(np.asarray(x).copy())


def rotations(rng):
    """Rotations at theta ~ 0, generic angles and within 1e-5 of pi."""
    axes = rng.normal(size=(9, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    angles = np.array([0.0, 1e-7, 3e-5, 0.3, 1.2, 2.5, np.pi - 1e-3, np.pi - 2e-5, np.pi])
    w = (axes * angles[:, None]).astype(np.float32)
    return np.asarray(jso3_exp(jnp.asarray(w)))


def test_so3_log_in_every_regime(rng):
    R = rotations(rng)
    got = so3_log(t(R)).numpy()
    want = np.asarray(jso3_log(jnp.asarray(R)))
    np.testing.assert_allclose(got, want, atol=1e-5)
    # The round trip lands where the JAX package's does (at theta = pi in
    # float32 the axis sign is the antisymmetric part's rounding noise).
    np.testing.assert_allclose(so3_exp(t(got)).numpy(), np.asarray(jso3_exp(jnp.asarray(want))), atol=1e-5)
    np.testing.assert_allclose(so3_exp(t(got)).numpy()[:-1], R[:-1], atol=1e-4)


def test_se3_log_in_every_regime(rng):
    R = rotations(rng)
    tr = rng.normal(size=(len(R), 3)).astype(np.float32)
    got = se3_log(t(R), t(tr)).numpy()
    want = np.asarray(jse3_log(jnp.asarray(R), jnp.asarray(tr)))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_so3_log_derivative_is_finite_at_identity():
    """Forward-mode derivative at R = I: the guarded square root keeps it
    finite (the pose graph's Jacobians are taken there)."""
    eye = torch.eye(3)
    tangent = torch.zeros(3, 3)
    tangent[0, 1], tangent[1, 0] = -1.0, 1.0
    _, d = torch.func.jvp(so3_log, (eye,), (tangent,))
    assert torch.isfinite(d).all()
    np.testing.assert_allclose(d.numpy(), [0.0, 0.0, 1.0], atol=1e-6)


def sim3_tangents(rng, n=12):
    xi = rng.normal(size=(n, 7)).astype(np.float32) * np.array([0.5] * 6 + [0.3], np.float32)
    xi[0] = 0.0
    xi[1, :3] = 0.0  # theta = 0, sigma != 0
    xi[2, 6] = 0.0   # sigma = 0, theta != 0
    xi[3, 6] = 3e-6  # sigma in its Taylor band
    return xi


def test_sim3_exp_log_compose_inverse_apply(rng):
    xi = sim3_tangents(rng)
    js, jR, jt = jsim3_exp(jnp.asarray(xi))
    s, R, tt = sim3_exp(t(xi))
    for a, b in ((s, js), (R, jR), (tt, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    np.testing.assert_allclose(sim3_log(s, R, tt).numpy(), np.asarray(jsim3_log(js, jR, jt)), atol=1e-5)
    np.testing.assert_allclose(sim3_log(s, R, tt).numpy(), xi, atol=1e-4)

    perm = rng.permutation(len(xi))
    got = sim3_compose(s, R, tt, s[perm], R[perm], tt[perm])
    want = jsim3_compose(js, jR, jt, js[perm], jR[perm], jt[perm])
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    for a, b in zip(sim3_inverse(s, R, tt), jsim3_inverse(js, jR, jt)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5, rtol=1e-5)
    x = rng.normal(size=(len(xi), 3)).astype(np.float32)
    np.testing.assert_allclose(sim3_apply(s, R, tt, t(x)).numpy(),
                               np.asarray(jsim3_apply(js, jR, jt, jnp.asarray(x))), atol=1e-5, rtol=1e-5)


def sim3_problem(rng, n=160, n_out=40, noise=0.5, fix_scale=False):
    """Matched camera-frame points of two keyframes related by a known S21,
    their pixels with noise, and outlier rows; the chi2 gates and weights
    of LoopCloser._compute_sim3 (octave 0..3)."""
    X1 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n), rng.uniform(3, 8, n)], 1)
    s = 1.0 if fix_scale else 1.3
    R = np.asarray(jso3_exp(jnp.asarray(np.array([0.05, -0.2, 0.03], np.float32))))
    tr = np.array([0.4, -0.1, 0.2])
    X2 = s * X1 @ R.T + tr
    proj = lambda X: X[:, :2] / X[:, 2:] * 500.0 + np.array([320.0, 240.0])
    uv1 = proj(X1) + rng.normal(0, noise, (n, 2))
    uv2 = proj(X2) + rng.normal(0, noise, (n, 2))
    out = rng.choice(n, n_out, replace=False)
    X2[out] += rng.normal(0, 0.8, (n_out, 3))
    valid = np.ones(n, bool)
    valid[rng.choice(n, 10, replace=False)] = False
    lvl = rng.integers(0, 4, n)
    sigma2 = (1.2 ** (2.0 * lvl)).astype(np.float32)
    f = lambda a: a.astype(np.float32)
    return f(X1), f(X2), f(uv1), f(uv2), sigma2, valid


def test_sim3_chi2_inliers_exact(rng):
    X1, X2, uv1, uv2, sigma2, valid = sim3_problem(rng)
    s = np.float32(1.3)
    R = np.asarray(jso3_exp(jnp.asarray(np.array([0.05, -0.2, 0.03], np.float32))))
    tr = np.array([0.4, -0.1, 0.2], np.float32)
    want = np.asarray(jsim3_chi2_inliers(jnp.asarray(K), jnp.asarray(s), jnp.asarray(R), jnp.asarray(tr),
                                         *map(jnp.asarray, (X1, X2, uv1, uv2, 9.21 * sigma2,
                                                            9.21 * sigma2, valid))))
    got = sim3_chi2_inliers(t(K), torch.tensor(s), t(R), t(tr), t(X1), t(X2), t(uv1), t(uv2),
                            t(9.21 * sigma2), t(9.21 * sigma2), t(valid)).numpy()
    np.testing.assert_array_equal(got, want)
    assert 100 < got.sum() < valid.sum()


@pytest.mark.parametrize("fix_scale", [False, True])
def test_sim3_ransac_matches_jax_with_its_picks(rng, fix_scale):
    X1, X2, uv1, uv2, sigma2, valid = sim3_problem(rng, fix_scale=fix_scale)
    key = jax.random.PRNGKey(7)
    args = (X1, X2, uv1, uv2, 9.21 * sigma2, 9.21 * sigma2, valid)
    jr = jsim3_ransac(key, jnp.asarray(K), *map(jnp.asarray, args), fix_scale=fix_scale, min_inliers=20)
    picks = np.asarray(jax.random.randint(key, (128, 3), 0, max(int(valid.sum()), 3)))
    r = sim3_ransac(t(K), *map(t, args), picks=t(picks), fix_scale=fix_scale, min_inliers=20)
    assert bool(r.success) and bool(jr.success)
    np.testing.assert_array_equal(r.inliers.numpy(), np.asarray(jr.inliers))
    assert int(r.n_inliers) == int(jr.n_inliers)
    np.testing.assert_allclose(float(r.s), float(jr.s), atol=1e-4)
    np.testing.assert_allclose(r.R.numpy(), np.asarray(jr.R), atol=1e-4)
    np.testing.assert_allclose(r.t.numpy(), np.asarray(jr.t), atol=1e-4)


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(rng, fix_scale):
    X1, X2, uv1, uv2, sigma2, valid = sim3_problem(rng, fix_scale=fix_scale)
    s0 = np.float32(1.0 if fix_scale else 1.25)
    R0 = np.asarray(jso3_exp(jnp.asarray(np.array([0.06, -0.18, 0.02], np.float32))))
    t0 = np.array([0.35, -0.05, 0.25], np.float32)
    args = (X1, X2, uv1, uv2, 1.0 / sigma2, 1.0 / sigma2, valid)
    js, jR, jt, jinl, jn = joptimize_sim3(jnp.asarray(K), jnp.asarray(s0), jnp.asarray(R0), jnp.asarray(t0),
                                          *map(jnp.asarray, args), fix_scale=fix_scale)
    s, R, tt, inl, n = optimize_sim3(t(K), torch.tensor(s0), t(R0), t(t0), *map(t, args),
                                     fix_scale=fix_scale)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-4)
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4 * np.abs(np.asarray(jt)).max())
    np.testing.assert_array_equal(inl.numpy(), np.asarray(jinl))
    assert int(n) == int(jn) > 80
