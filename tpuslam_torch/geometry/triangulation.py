"""Batched linear triangulation. Port of tpuslam/geometry/triangulation.py.

The DLT rows r_i (X; 1) = 0 are solved in inhomogeneous form: the 3x3
normal equations (A^T A) X = -A^T a with a closed-form adjugate inverse,
elementwise math over any leading batch dims (no torch.linalg). The
normal-matrix determinant is returned as the conditioning signal; callers
reject points near infinity with it.
"""

from __future__ import annotations

import torch


def _solve3_adjugate(m: torch.Tensor, b: torch.Tensor, eps: float = 1e-12):
    """Batched 3x3 solve via the adjugate; returns (x, det)."""
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c02 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c10 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c20 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c21 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = m[..., 0, 0] * c00 + m[..., 0, 1] * c10 + m[..., 0, 2] * c20
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    safe = torch.where(torch.abs(det) < eps, torch.full_like(det, eps), det)
    return torch.einsum("...ij,...j->...i", adj, b) / safe[..., None], det


def triangulate_dlt(P1: torch.Tensor, P2: torch.Tensor, uv1: torch.Tensor, uv2: torch.Tensor):
    """DLT triangulation from (..., 3, 4) projection matrices and (..., 2)
    pixels. Returns (x_world (..., 3), w (...,)): w is the normal-matrix
    determinant of the row-normalized system, ~0 at or near infinity."""
    rows = [
        uv1[..., 0, None] * P1[..., 2, :] - P1[..., 0, :],
        uv1[..., 1, None] * P1[..., 2, :] - P1[..., 1, :],
        uv2[..., 0, None] * P2[..., 2, :] - P2[..., 0, :],
        uv2[..., 1, None] * P2[..., 2, :] - P2[..., 1, :],
    ]
    A = torch.stack(rows, dim=-2)  # (..., 4, 4)
    A = A / torch.clamp(torch.sqrt(torch.sum(A * A, dim=-1, keepdim=True)), min=1e-12)
    A3 = A[..., :3]
    a4 = A[..., 3]
    AtA = torch.einsum("...ij,...ik->...jk", A3, A3)
    Atb = -torch.einsum("...ij,...i->...j", A3, a4)
    return _solve3_adjugate(AtA, Atb)


def triangulate_two_view(R1, t1, R2, t2, K, uv1, uv2):
    """Triangulate with world->camera poses (..., 3, 3) / (..., 3) and shared
    intrinsics K (3, 3) from undistorted pixels (..., 2). Returns (x_world,
    w) as triangulate_dlt."""
    P1 = K @ torch.cat([R1, t1[..., None]], dim=-1)
    P2 = K @ torch.cat([R2, t2[..., None]], dim=-1)
    return triangulate_dlt(P1, P2, uv1, uv2)
