"""The port's bundle adjusters against the JAX package's on the CPU, on a
seeded problem: six keyframes in an arc over 150 points, perturbed, with
keyframe 0 and 20 points fixed, 10% of the edges invalid, octave-scaled
information and (in one case) stereo edges. The CG solver and the dense
Schur solver with padded active slots, the inactive keyframes held fixed.

Both sides run the same LM schedule; float sums come in another order
(index_add_ against XLA's scatter), so poses agree within 2e-4, points within
2e-3 and the edge chi2 within 1e-3 relative (2e-3 absolute).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuslam.geometry import project, se3_apply, so3_exp
from tpuslam.geometry.camera import PinholeCamera as JCamera
from tpuslam.optim.ba import BAProblem as JBAProblem
from tpuslam.optim.ba import bundle_adjustment as jba, dense_schur_bundle_adjustment as jdense
from tpuslam_torch.convert import ba_problem_to_torch
from tpuslam_torch.geometry.camera import PinholeCamera
from tpuslam_torch.optim.ba import _chol3, bundle_adjustment, dense_schur_bundle_adjustment

torch.set_num_threads(2)

BF = 500.0 * 0.12


def make_problem(seed, stereo=False, K=6, P=150):
    rng = np.random.default_rng(seed)
    jcam = JCamera(fx=500.0, fy=500.0, cx=320.0, cy=240.0, bf=BF if stereo else 0.0)
    X_gt = np.stack([rng.uniform(-3, 3, P), rng.uniform(-2, 2, P), rng.uniform(5, 12, P)], -1).astype(np.float32)
    R_gt = np.stack([np.asarray(so3_exp(jnp.asarray([0.0, -0.04 * k, 0.0]))) for k in range(K)])
    t_gt = np.stack([np.array([-0.3 * k, 0.0, 0.0], np.float32) for k in range(K)])
    kf, pt, uvr = [], [], []
    for k in range(K):
        p_cam = np.asarray(se3_apply(jnp.asarray(R_gt[k]), jnp.asarray(t_gt[k]), jnp.asarray(X_gt)))
        uv = np.asarray(project(jcam, jnp.asarray(p_cam)))
        for j in np.nonzero((uv[:, 0] > 10) & (uv[:, 0] < 630) & (uv[:, 1] > 10) & (uv[:, 1] < 470))[0]:
            ur = uv[j, 0] - BF / p_cam[j, 2] + rng.normal() * 0.3 if stereo and j % 2 == 0 else -1.0
            kf.append(k)
            pt.append(j)
            uvr.append([uv[j, 0] + rng.normal() * 0.3, uv[j, 1] + rng.normal() * 0.3, ur])
    E = len(kf)
    R0 = np.stack([np.asarray(so3_exp(jnp.asarray(rng.normal(size=3).astype(np.float32) * 0.01))) @ R_gt[k]
                   for k in range(K)])
    t0 = t_gt + rng.normal(size=t_gt.shape).astype(np.float32) * 0.05
    X0 = X_gt + rng.normal(size=X_gt.shape).astype(np.float32) * 0.1
    R0[0], t0[0] = R_gt[0], t_gt[0]
    fixed_kf = np.zeros(K, bool)
    fixed_kf[0] = True
    fixed_pt = np.zeros(P, bool)
    fixed_pt[:20] = True
    prob = JBAProblem(
        R=R0.astype(np.float32), t=t0.astype(np.float32), X=X0,
        kf=np.array(kf, np.int32), pt=np.array(pt, np.int32), uvr=np.array(uvr, np.float32),
        inv_sigma2=(1.0 / 1.44 ** rng.integers(0, 3, E)).astype(np.float32),
        valid=rng.uniform(size=E) > 0.1, fixed_kf=fixed_kf, fixed_pt=fixed_pt,
    )
    return jcam, PinholeCamera(**jcam._asdict()), prob, (R_gt, t_gt, X_gt)


def assert_ba_close(got, ref, prob):
    R, t, X, chi2 = (x.numpy() for x in got)
    jR, jt, jX, jchi2 = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(R, jR, atol=2e-4)
    np.testing.assert_allclose(t, jt, atol=2e-4)
    np.testing.assert_allclose(X, jX, rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(chi2, jchi2, rtol=1e-3, atol=2e-3)
    # Fixed blocks did not move.
    np.testing.assert_array_equal(X[prob.fixed_pt], prob.X[prob.fixed_pt])
    np.testing.assert_allclose(R[0], prob.R[0], atol=1e-6)


def _jax_prob(prob):
    return JBAProblem(*(jnp.asarray(x) for x in prob))


@pytest.mark.parametrize("stereo", [False, True])
def test_bundle_adjustment_matches_jax(stereo):
    jcam, cam, prob, (R_gt, t_gt, _) = make_problem(0, stereo)
    ref = jba(jcam, _jax_prob(prob), iters=10)
    got = bundle_adjustment(cam, ba_problem_to_torch(prob, "cpu"), iters=10)
    assert_ba_close(got, ref, prob)
    _, _, _, chi2_0 = bundle_adjustment(cam, ba_problem_to_torch(prob, "cpu"), iters=0)
    v = prob.valid
    assert float(got[3].numpy()[v].sum()) < 0.2 * float(chi2_0.numpy()[v].sum())


@pytest.mark.parametrize("active", [[1, 2, 3, 4, 5, -1, -1, -1], [2, 4, -1, -1]])
def test_dense_schur_matches_jax(active):
    """Padded active slots; the keyframes left out stay where they were."""
    jcam, cam, prob, _ = make_problem(1)
    act = np.array(active, np.int32)
    ref = jdense(jcam, _jax_prob(prob), jnp.asarray(act), iters=10)
    got = dense_schur_bundle_adjustment(cam, ba_problem_to_torch(prob, "cpu"), torch.from_numpy(act), iters=10)
    assert_ba_close(got, ref, prob)
    for k in set(range(6)) - set(active):
        np.testing.assert_allclose(got[0].numpy()[k], prob.R[k], atol=1e-5)
        np.testing.assert_allclose(got[1].numpy()[k], prob.t[k], atol=1e-5)


def test_dense_schur_stereo_matches_cg_solver():
    """Both solvers reach the same stationary point."""
    _, cam, prob, _ = make_problem(2, stereo=True)
    tp = ba_problem_to_torch(prob, "cpu")
    R1, t1, X1, _ = bundle_adjustment(cam, tp, iters=15, cg_iters=80)
    R2, t2, X2, _ = dense_schur_bundle_adjustment(cam, tp, torch.tensor([1, 2, 3, 4, 5, -1]), iters=15)
    np.testing.assert_allclose(R1.numpy(), R2.numpy(), atol=2e-3)
    np.testing.assert_allclose(t1.numpy(), t2.numpy(), atol=2e-2)


def test_chol3_factors_spd_blocks(rng):
    A = rng.normal(size=(50, 3, 3)).astype(np.float32)
    S = A @ A.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    L = _chol3(torch.from_numpy(S)).numpy()
    np.testing.assert_allclose(L @ L.transpose(0, 2, 1), S, rtol=1e-4, atol=1e-4)
    assert np.allclose(np.triu(L, 1), 0.0)
