"""Horn's closed-form similarity. Port of horn_sim3 from
tpuslam/sfm/sim3solver.py (the Sim3 RANSAC and its refinement belong to loop
closing and are not ported yet)."""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.se3 import quat_to_rotmat


def horn_sim3(P1: torch.Tensor, P2: torch.Tensor, w: torch.Tensor, fix_scale: bool = False):
    """(s, R, t) with P2 ~ s R P1 + t for (n, 3) point sets and (n,) weights:
    Horn's 1987 quaternion method (the dominant eigenvector of the 4x4 N
    matrix), scale as dot(P2', R P1') / |P1'|^2 (Sim3Solver::ComputeSim3)."""
    wsum = torch.clamp(w.sum(), min=1e-9)
    c1 = torch.sum(P1 * w[:, None], dim=0) / wsum
    c2 = torch.sum(P2 * w[:, None], dim=0) / wsum
    A = (P1 - c1) * w[:, None]
    B = P2 - c2
    M = A.T @ B
    sxx, sxy, sxz = M[0, 0], M[0, 1], M[0, 2]
    syx, syy, syz = M[1, 0], M[1, 1], M[1, 2]
    szx, szy, szz = M[2, 0], M[2, 1], M[2, 2]
    N = torch.stack([
        torch.stack([sxx + syy + szz, syz - szy, szx - sxz, sxy - syx]),
        torch.stack([syz - szy, sxx - syy - szz, sxy + syx, szx + sxz]),
        torch.stack([szx - sxz, sxy + syx, -sxx + syy - szz, syz + szy]),
        torch.stack([sxy - syx, szx + sxz, syz + szy, -sxx - syy + szz]),
    ])
    _, eigvec = torch.linalg.eigh(N)
    q_wxyz = eigvec[:, 3]  # the largest eigenvalue's
    R = quat_to_rotmat(torch.stack([q_wxyz[1], q_wxyz[2], q_wxyz[3], q_wxyz[0]]))
    RP1 = (P1 - c1) @ R.T
    num = torch.sum(B * RP1 * w[:, None])
    den = torch.clamp(torch.sum(((P1 - c1) ** 2) * w[:, None]), min=1e-12)
    s = torch.ones_like(num) if fix_scale else torch.clamp(num / den, min=1e-6)
    return s, R, c2 - s * (R @ c1)
