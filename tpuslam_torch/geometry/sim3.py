"""Sim(3) similarity transforms (s, R, t): x' = s R x + t, batched over
leading dims. Port of tpuslam/geometry/sim3.py. The 7-vector tangent is
[omega (3), v (3), sigma (1)] with s = exp(sigma).
"""

from __future__ import annotations

import torch

from tpuslam_torch.geometry.se3 import _eye_like, _sinc_factors, hat, so3_exp, so3_log


def _sim3_W(w: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """The matrix W with t = W v (Eade's notation): C I + A [w]x + B [w]x^2,
    its coefficients Taylor-guarded near sigma = 0 and theta = 0, the
    square root guarded before it is evaluated."""
    theta_sq = torch.sum(w * w, dim=-1)
    s = torch.exp(sigma)
    small_sigma = torch.abs(sigma) < 1e-5
    small_theta = theta_sq < 1e-10
    safe_sigma = torch.where(small_sigma, torch.ones_like(sigma), sigma)
    safe_theta_sq = torch.where(small_theta, torch.ones_like(theta_sq), theta_sq)
    safe_theta = torch.sqrt(safe_theta_sq)

    X = torch.where(small_sigma, 1.0 + sigma / 2.0, (s - 1.0) / safe_sigma)
    denom = safe_sigma * safe_sigma + safe_theta_sq
    a = s * torch.sin(safe_theta)
    b = s * torch.cos(safe_theta)
    A_gen = (a * safe_sigma + (1.0 - b) * safe_theta) / (safe_theta * denom)
    B_gen = (X - ((b - 1.0) * safe_sigma + a * safe_theta) / denom) / safe_theta_sq

    _, A_sig0, B_sig0 = _sinc_factors(theta_sq)
    A_th0 = torch.where(small_sigma, 0.5 + sigma / 6.0,
                        ((safe_sigma - 1.0) * s + 1.0) / (safe_sigma * safe_sigma))
    B_th0 = torch.where(
        small_sigma, torch.full_like(sigma, 1.0 / 6.0),
        (s * (0.5 * safe_sigma * safe_sigma - safe_sigma + 1.0) - 1.0)
        / (safe_sigma * safe_sigma * safe_sigma))

    A_ = torch.where(small_theta, A_th0, torch.where(small_sigma, A_sig0, A_gen))
    B_ = torch.where(small_theta, B_th0, torch.where(small_sigma, B_sig0, B_gen))
    K = hat(w)
    return X[..., None, None] * _eye_like(K) + A_[..., None, None] * K + B_[..., None, None] * (K @ K)


def sim3_exp(xi: torch.Tensor):
    """Tangent (..., 7) -> (s (...,), R (..., 3, 3), t (..., 3))."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    W = _sim3_W(w, sigma)
    return torch.exp(sigma), so3_exp(w), (W @ v[..., None])[..., 0]


def sim3_log(s: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(s, R, t) -> tangent (..., 7), the inverse of sim3_exp (W solved)."""
    w = so3_log(R)
    sigma = torch.log(torch.clamp(s, min=1e-12))
    v = torch.linalg.solve(_sim3_W(w, sigma), t[..., None])[..., 0]
    return torch.cat([w, v, sigma[..., None]], dim=-1)


def sim3_compose(s1, R1, t1, s2, R2, t2):
    """S1 * S2: x -> s1 R1 (s2 R2 x + t2) + t1."""
    return s1 * s2, R1 @ R2, s1[..., None] * (R1 @ t2[..., None])[..., 0] + t1


def sim3_inverse(s, R, t):
    Rt = R.transpose(-1, -2)
    s_inv = 1.0 / s
    return s_inv, Rt, -s_inv[..., None] * (Rt @ t[..., None])[..., 0]


def sim3_apply(s, R, t, x):
    return s[..., None] * (R @ x[..., None])[..., 0] + t
