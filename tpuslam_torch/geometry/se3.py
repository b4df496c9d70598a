"""SO(3)/SE(3) operations on tensors with arbitrary leading batch dims.

Port of tpuslam/geometry/se3.py. Convention T_cw: x_cam = R @ x_world + t.
"""

from __future__ import annotations

import torch

# Squared angle below which Taylor expansions replace the closed forms.
_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [w]x from (..., 3) vectors -> (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def _sinc_factors(theta_sq: torch.Tensor):
    """(A, B, C) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3), Taylor-safe."""
    small = theta_sq < _EPS
    safe_tsq = torch.where(small, torch.ones_like(theta_sq), theta_sq)
    safe_t = torch.sqrt(safe_tsq)
    a = torch.where(small, 1.0 - theta_sq / 6.0, torch.sin(safe_t) / safe_t)
    b = torch.where(small, 0.5 - theta_sq / 24.0, (1.0 - torch.cos(safe_t)) / safe_tsq)
    c = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (safe_t - torch.sin(safe_t)) / (safe_tsq * safe_t),
    )
    return a, b, c


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: axis-angle (..., 3) -> rotation matrices (..., 3, 3)."""
    a, b, _ = _sinc_factors(torch.sum(w * w, dim=-1))
    K = hat(w)
    return _eye_like(K) + a[..., None, None] * K + b[..., None, None] * (K @ K)


def se3_exp(xi: torch.Tensor):
    """Twist (..., 6) [omega, v] -> (R (..., 3, 3), t (..., 3))."""
    w, v = xi[..., :3], xi[..., 3:]
    a, b, c = _sinc_factors(torch.sum(w * w, dim=-1))
    K = hat(w)
    KK = K @ K
    eye = _eye_like(K)
    R = eye + a[..., None, None] * K + b[..., None, None] * KK
    V = eye + b[..., None, None] * K + c[..., None, None] * KK
    return R, (V @ v[..., None])[..., 0]


def so3_project(R: torch.Tensor) -> torch.Tensor:
    """Project near-rotations back onto SO(3) by three Newton-Schulz polar
    iterations (see tpuslam/geometry/se3.py::so3_project for why)."""
    X = R
    eye = _eye_like(R)
    for _ in range(3):
        X = 0.5 * X @ (3.0 * eye - X.transpose(-1, -2) @ X)
    return X


def se3_compose(R1, t1, R2, t2):
    """T1 * T2: first apply T2, then T1."""
    return R1 @ R2, (R1 @ t2[..., None])[..., 0] + t1


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def se3_apply(R, t, x):
    """Apply transform to points x (..., 3). With R (..., 3, 3) and x (...,
    N, 3) (a transform for each set of N points) it is the matrix product
    x R^T, which rounds as the JAX package's CPU matmul does; t then
    broadcasts against (..., N, 3). Otherwise R's batch dims broadcast
    against x's."""
    if R.dim() == x.dim():
        return x @ R.transpose(-1, -2) + t
    return (R @ x[..., None])[..., 0] + t


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (..., 4) [x, y, z, w] -> rotation matrix (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    x, y, z, w = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], dim=-1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], dim=-1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], dim=-1),
        ],
        dim=-2,
    )


def rotmat_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4) [x, y, z, w],
    w >= 0. Branch-free Shepperd's method: all four candidates, the best
    conditioned one selected (the first on a tie, as jnp.argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-12))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([(m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0, 0.25 * s0], dim=-1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1, (m21 - m12) / s1], dim=-1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2, (m02 - m20) / s2], dim=-1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3, (m10 - m01) / s3], dim=-1)

    scores = torch.stack([tr, m00 - m11 - m22, m11 - m00 - m22, m22 - m00 - m11], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)  # (..., 4, 4)
    q = torch.gather(qs, -2, idx[..., None, None].expand(*idx.shape, 1, 4))[..., 0, :]
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=1e-12)
    return q * torch.where(q[..., 3:4] < 0.0, -1.0, 1.0)
