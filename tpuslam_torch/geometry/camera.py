"""Pinhole camera with radial-tangential distortion. Port of
tpuslam/geometry/camera.py."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PinholeCamera(NamedTuple):
    """Intrinsics + radtan distortion (k1, k2, p1, p2, k3) + stereo baseline,
    as Python floats (the same fields as the JAX package's camera)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    bf: float = 0.0  # baseline * fx (stereo/RGB-D); 0 for mono
    width: int = 640
    height: int = 480

    @property
    def K(self) -> torch.Tensor:
        return torch.tensor(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=torch.float32,
        )

    @property
    def baseline(self) -> float:
        return self.bf / self.fx


def distort(cam: PinholeCamera, xn: torch.Tensor) -> torch.Tensor:
    """Apply radtan distortion to normalized coords (..., 2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = 1.0 + cam.k1 * r2 + cam.k2 * r4 + cam.k3 * r6
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def project(cam: PinholeCamera, x_cam: torch.Tensor, distorted: bool = False) -> torch.Tensor:
    """Camera-frame 3D points (..., 3) -> pixel coords (..., 2): undistorted
    by default (what tracking and optimization use), raw-sensor pixels with
    distorted=True."""
    z = x_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    xn = x_cam[..., :2] * inv_z[..., None]
    if distorted:
        xn = distort(cam, xn)
    u = cam.fx * xn[..., 0] + cam.cx
    v = cam.fy * xn[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def project_stereo(cam: PinholeCamera, x_cam: torch.Tensor) -> torch.Tensor:
    """Camera-frame 3D points (..., 3) -> (u_left, v, u_right) (..., 3),
    u_right = u_left - bf / z, the virtual right coordinate of stereo and
    RGB-D observations."""
    uv = project(cam, x_cam)
    z = x_cam[..., 2]
    z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
    # float32(bf) / z, a true division (the scalar's __rtruediv__ would
    # multiply by a reciprocal and round twice).
    ur = uv[..., 0] - torch.full_like(z, cam.bf) / z
    return torch.cat([uv, ur[..., None]], dim=-1)


def unproject(cam: PinholeCamera, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
    """Undistorted pixels (..., 2) + depth (...,) -> camera-frame 3D (..., 3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return torch.stack([x, y, depth], dim=-1)


def undistort_points(cam: PinholeCamera, uv: torch.Tensor, iters: int = 8) -> torch.Tensor:
    """Distorted pixels (..., 2) -> undistorted pixels by fixed-point
    inversion of the radtan model (cv::undistortPoints semantics)."""
    xd = torch.stack([(uv[..., 0] - cam.cx) / cam.fx, (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xn = xd
    for _ in range(iters):
        x, y = xn[..., 0], xn[..., 1]
        r2 = x * x + y * y
        radial = 1.0 + cam.k1 * r2 + cam.k2 * r2 * r2 + cam.k3 * r2 * r2 * r2
        dx = 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
        dy = cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
        inv_radial = 1.0 / torch.where(
            torch.abs(radial) < 1e-9, torch.full_like(radial, 1e-9), radial
        )
        xn = torch.stack([(xd[..., 0] - dx) * inv_radial, (xd[..., 1] - dy) * inv_radial], dim=-1)
    u = cam.fx * xn[..., 0] + cam.cx
    v = cam.fy * xn[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)
