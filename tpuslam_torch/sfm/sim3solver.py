"""Horn's closed-form similarity, the batched Sim3 RANSAC and its
Gauss-Newton refinement. Port of tpuslam/sfm/sim3solver.py.

The RANSAC's 3-point sets come from `picks` (n_hyp, 3) indices into the
valid rows, as every RANSAC of the port takes them: the caller draws them
(from a torch.Generator, or a replay of the JAX key chain).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from tpuslam_torch.geometry.se3 import quat_to_rotmat
from tpuslam_torch.geometry.sim3 import sim3_apply, sim3_compose, sim3_exp, sim3_inverse
from tpuslam_torch.sfm.initializer import _pick
from tpuslam_torch.utils.metrics import traced


def horn_sim3(P1: torch.Tensor, P2: torch.Tensor, w: torch.Tensor, fix_scale: bool = False):
    """(s, R, t) with P2 ~ s R P1 + t for (n, 3) point sets and (..., n)
    weights (a batch of hypotheses over the leading dims): Horn's 1987
    quaternion method (the dominant eigenvector of the 4x4 N matrix), scale
    as dot(P2', R P1') / |P1'|^2 (Sim3Solver::ComputeSim3)."""
    wc = w[..., None]
    wsum = torch.clamp(w.sum(-1), min=1e-9)[..., None]
    c1 = torch.sum(P1 * wc, dim=-2) / wsum
    c2 = torch.sum(P2 * wc, dim=-2) / wsum
    A = (P1 - c1[..., None, :]) * wc
    B = P2 - c2[..., None, :]
    M = A.transpose(-1, -2) @ B
    sxx, sxy, sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    syx, syy, syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    szx, szy, szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx], dim=-1),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz], dim=-1),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy], dim=-1),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz], dim=-1),
    ], dim=-2)
    with traced("read.sim3"):  # cuSOLVER checks its status on the host
        _, eigvec = torch.linalg.eigh(N)
    q_wxyz = eigvec[..., :, 3]  # the largest eigenvalue's
    R = quat_to_rotmat(torch.stack([q_wxyz[..., 1], q_wxyz[..., 2], q_wxyz[..., 3],
                                    q_wxyz[..., 0]], dim=-1))
    P1c = P1 - c1[..., None, :]
    RP1 = P1c @ R.transpose(-1, -2)
    num = torch.sum(B * RP1 * wc, dim=(-2, -1))
    den = torch.clamp(torch.sum((P1c ** 2) * wc, dim=(-2, -1)), min=1e-12)
    s = torch.ones_like(num) if fix_scale else torch.clamp(num / den, min=1e-6)
    return s, R, c2 - s[..., None] * (R @ c1[..., None])[..., 0]


class Sim3Result(NamedTuple):
    success: torch.Tensor
    s: torch.Tensor
    R: torch.Tensor  # rotation 1 -> 2
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _project(K: torch.Tensor, P: torch.Tensor) -> torch.Tensor:
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    z = P[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    return torch.stack([fx * P[..., 0] / z + cx, fy * P[..., 1] / z + cy], dim=-1)


def sim3_chi2_inliers(K, s, R, t, X1, X2, uv1, uv2, chi2_1, chi2_2, valid):
    """Mutual-reprojection chi2 inlier mask of S21 (Sim3Solver::CheckInliers):
    X1 through S21 against uv2 and X2 through S21^-1 against uv1, both
    squared errors under their gates. Batched over the leading dims of s,
    R (..., 3, 3) and t (..., 3)."""
    with traced("read.sim3"):  # the host's K copied to the card: a synchronising copy
        K = K.to(X1.device)
    X1in2 = s[..., None, None] * (X1 @ R.transpose(-1, -2)) + t[..., None, :]
    e2 = torch.sum((_project(K, X1in2) - uv2) ** 2, dim=-1)
    sinv = 1.0 / s
    Rinv = R.transpose(-1, -2)
    tinv = -sinv[..., None] * (Rinv @ t[..., None])[..., 0]
    X2in1 = sinv[..., None, None] * (X2 @ Rinv.transpose(-1, -2)) + tinv[..., None, :]
    e1 = torch.sum((_project(K, X2in1) - uv1) ** 2, dim=-1)
    return valid & (e1 < chi2_1) & (e2 < chi2_2)


def sim3_ransac(K, X1, X2, uv1, uv2, chi2_1, chi2_2, valid, picks: torch.Tensor,
                fix_scale: bool = False, min_inliers: int = 20) -> Sim3Result:
    """RANSAC Sim3 S21 (camera-1 to camera-2 coordinates) between two
    keyframes' matched camera-frame points X1/X2 (N, 3) and their pixels
    uv1/uv2, per-point chi2 gates chi2_1/chi2_2. `picks` (n_hyp, 3) index
    the valid rows (the JAX package draws them with jax.random.randint in
    [0, max(n_valid, 3))). No host read."""
    dev = X1.device
    n = X1.shape[0]
    valid_idx = torch.argsort((~valid).to(torch.int8), stable=True)
    sets = valid_idx[picks.to(dev).long()]  # (n_hyp, 3)

    def count(s, R, t):
        return sim3_chi2_inliers(K, s, R, t, X1, X2, uv1, uv2, chi2_1, chi2_2, valid)

    # Repeated indices within a set weigh once, as .at[idx3].set(1.0).
    w3 = torch.zeros((sets.shape[0], n), device=dev).scatter(1, sets, 1.0)
    ss, Rs, ts = horn_sim3(X1, X2, w3, fix_scale)
    counts = count(ss, Rs, ts).sum(-1, dtype=torch.int32)
    best = torch.argmax(counts)
    s, R, t = _pick(ss, best), _pick(Rs, best), _pick(ts, best)
    inl = count(s, R, t)

    s2, R2, t2 = horn_sim3(X1, X2, inl.to(torch.float32) + 1e-9, fix_scale)
    inl2 = count(s2, R2, t2)
    better = inl2.sum() >= inl.sum()
    s = torch.where(better, s2, s)
    R = torch.where(better, R2, R)
    t = torch.where(better, t2, t)
    inliers = torch.where(better, inl2, inl)
    n_inl = inliers.sum(dtype=torch.int32)
    return Sim3Result(n_inl >= min_inliers, s, R, t, inliers, n_inl)


def optimize_sim3(K, s0, R0, t0, X1, X2, uv1, uv2, inv_sigma2_1, inv_sigma2_2, valid,
                  fix_scale: bool = False, iters: int = 10, chi2_th: float = 9.9999):
    """Gauss-Newton refinement of a relative Sim3 with the bidirectional
    reprojection residuals of Optimizer::OptimizeSim3: X1 into camera 2
    through S21 and X2 into camera 1 through S21^-1. Outliers (chi2 >
    chi2_th) are reclassified after the first half of the fixed `iters`
    (no early exit). The (4N, 7) Jacobian is forward-mode
    (torch.func.jacfwd at the zero tangent), as jax.jacfwd in the JAX
    package. Returns (s, R, t, inliers, n_inliers)."""
    with traced("read.sim3"):  # the host's K copied to the card: a synchronising copy
        K = K.to(X1.device)
    zero = torch.zeros(7, device=X1.device)
    eye7 = torch.eye(7, device=X1.device)

    def residuals(p, s, R, t):
        # The pose as a batch of one: under forward-mode AD a 0-d tensor
        # divided by a Python float gets a float64 tangent.
        s_, R_, t_ = sim3_compose(*sim3_exp(p[None]), s, R, t)
        e2 = _project(K, sim3_apply(s_.expand(X1.shape[0]), R_, t_, X1)) - uv2
        si, Ri, ti = sim3_inverse(s_, R_, t_)
        e1 = _project(K, sim3_apply(si.expand(X2.shape[0]), Ri, ti, X2)) - uv1
        return e1, e2

    def chi2(s, R, t):
        e1, e2 = residuals(zero, s, R, t)
        return torch.sum(e1 * e1, -1) * inv_sigma2_1 + torch.sum(e2 * e2, -1) * inv_sigma2_2

    def gn_rounds(s, R, t, active, n_iters):
        w1 = torch.sqrt(inv_sigma2_1 * active)[:, None]
        w2 = torch.sqrt(inv_sigma2_2 * active)[:, None]
        for _ in range(n_iters):
            def flat_res(p):
                e1, e2 = residuals(p, s, R, t)
                return torch.cat([(e1 * w1).reshape(-1), (e2 * w2).reshape(-1)])

            r = flat_res(zero)
            J = torch.func.jacfwd(flat_res)(zero)  # (4N, 7)
            if fix_scale:
                J = torch.cat([J[:, :6], torch.zeros_like(J[:, 6:])], dim=1)
            dx = torch.linalg.solve(J.T @ J + 1e-6 * eye7, -(J.T @ r))
            if fix_scale:
                dx = torch.cat([dx[:6], torch.zeros_like(dx[6:])])
            s, R, t = sim3_compose(*sim3_exp(dx), s, R, t)
        return s, R, t

    s, R, t = gn_rounds(s0, R0, t0, valid.to(torch.float32), iters // 2)
    inliers = valid & (chi2(s, R, t) <= chi2_th)
    s, R, t = gn_rounds(s, R, t, inliers.to(torch.float32), iters - iters // 2)
    inliers = valid & (chi2(s, R, t) <= chi2_th)
    return s, R, t, inliers, inliers.sum(dtype=torch.int32)
