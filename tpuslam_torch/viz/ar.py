"""AR on the sparse map: plane detection from the map points and a cube
overlay. Port of tpuslam/viz/ar.py.

The counterpart of the reference's monocular AR demo
(Examples/ROS/ORB_SLAM2/src/AR/ViewerAR.{h,cc}):

- `detect_plane` is ViewerAR::DetectPlane: RANSAC planes from the map
  points, scored by the 20th-percentile absolute distance (the
  max(0.2 N, 20)-th order statistic), inliers at 1.4x the best score,
  refit by total least squares (Plane::Recompute). The 50 hypotheses are
  one batch on the points' device: a (50, N) sort gives every order
  statistic at once. The 3-point sets come as `picks`, drawn from a
  torch.Generator as every RANSAC of the port draws them.
- `draw_ar_cube` replaces the GL cube (ViewerAR::DrawCube) with a
  projected wireframe on the frame image, drawn with PIL as viz/render.py
  draws.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from tpuslam_torch.geometry.camera import project
from tpuslam_torch.geometry.se3 import se3_apply
from tpuslam_torch.sfm.initializer import draw_picks


class PlaneFit(NamedTuple):
    success: torch.Tensor  # () bool
    normal: torch.Tensor   # (3,) unit, oriented toward the camera
    origin: torch.Tensor   # (3,) inlier centroid
    inliers: torch.Tensor  # (N,) bool


def _dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis of 3, as separate products and adds (no
    reduction whose order differs between the CPU and the card)."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def detect_plane(pts_w: torch.Tensor, valid: torch.Tensor, cam_center, *, generator=None,
                 picks=None, n_iters: int = 50, min_points: int = 50) -> PlaneFit:
    """RANSAC a dominant plane from (N, 3) world points with a validity
    mask, on their device.

    cam_center: the camera position in world coordinates (orients the
    normal so the cube is drawn on the visible side). picks (n_iters, 3):
    indices into the valid points (in [0, max(n_valid, 3))), else drawn
    from `generator`. Succeeds with >= min_points valid points
    (ViewerAR.cc requires 50). No host read.
    """
    dev = pts_w.device
    N = pts_w.shape[0]
    n_valid = valid.sum(dtype=torch.int32)
    valid_idx = torch.argsort((~valid).to(torch.int8), stable=True)  # valid slots first
    if picks is None:
        picks = draw_picks(n_iters, 3, valid, generator)
    sets = valid_idx[picks.to(dev).long()]  # (I, 3)
    p0, p1, p2 = pts_w[sets[:, 0]], pts_w[sets[:, 1]], pts_w[sets[:, 2]]

    big = 1e10
    nvec = torch.linalg.cross(p1 - p0, p2 - p0)
    nn = torch.sqrt(_dot3(nvec, nvec))
    nvec = nvec / torch.where(nn < 1e-9, torch.ones_like(nn), nn)[:, None]
    d = -_dot3(nvec, p0)
    dist = torch.abs(_dot3(pts_w[None], nvec[:, None]) + d[:, None])  # (I, N)
    dist = torch.where(valid, dist, torch.full_like(dist, big))
    s = torch.sort(dist, dim=1).values
    nth = torch.clamp(torch.clamp((torch.tensor(0.2, device=dev) * n_valid).to(torch.int32), min=20),
                      0, N - 1)
    scores = torch.where(nn < 1e-9, torch.full_like(nn, big),
                         s.index_select(1, nth.reshape(1).long())[:, 0])
    best = torch.argmin(scores).reshape(1)
    best_score = scores.index_select(0, best)[0]
    nb, db = nvec.index_select(0, best)[0], d.index_select(0, best)[0]
    inliers = valid & (torch.abs(_dot3(pts_w, nb) + db) < 1.4 * best_score)

    # Refit: total least squares over the inliers (Plane::Recompute), the
    # centroid and the smallest-eigenvalue direction of the scatter matrix.
    w = inliers.to(torch.float32)
    wsum = torch.clamp(w.sum(), min=1.0)
    centroid = (pts_w * w[:, None]).sum(0) / wsum
    dp = (pts_w - centroid) * w[:, None]
    cov = dp.T @ dp / wsum
    _, evecs = torch.linalg.eigh(cov)
    normal = evecs[:, 0]  # smallest eigenvalue
    # Orient toward the camera (ViewerAR flips by the view direction).
    to_cam = torch.as_tensor(cam_center, dtype=torch.float32, device=dev) - centroid
    normal = normal * torch.where(_dot3(normal, to_cam) < 0, -1.0, 1.0)
    success = (n_valid >= min_points) & (best_score < big)
    return PlaneFit(success, normal, centroid, inliers)


def plane_frame(normal: torch.Tensor) -> torch.Tensor:
    """(3, 3) rotation whose z-axis is the plane normal (columns: the plane's
    x, y, z axes in world coordinates), like the normal-to-rotation
    construction of Plane::Recompute."""
    z = normal / torch.clamp(torch.linalg.norm(normal), min=1e-9)
    up = torch.where(torch.abs(z[1]) < 0.9, torch.tensor([0.0, 1.0, 0.0], device=z.device),
                     torch.tensor([1.0, 0.0, 0.0], device=z.device))
    x = torch.linalg.cross(up, z)
    x = x / torch.clamp(torch.linalg.norm(x), min=1e-9)
    y = torch.linalg.cross(z, x)
    return torch.stack([x, y, z], dim=1)


_CUBE_EDGES = [
    (0, 1), (1, 3), (3, 2), (2, 0),
    (4, 5), (5, 7), (7, 6), (6, 4),
    (0, 4), (1, 5), (2, 6), (3, 7),
]


def cube_vertices(plane: PlaneFit, size: float) -> np.ndarray:
    """(8, 3) world-space vertices of a cube of side `size` resting on the
    plane at its origin."""
    Rp = plane_frame(plane.normal).cpu().numpy()
    o = plane.origin.cpu().numpy()
    h = size / 2.0
    verts = []
    for dz in (0.0, size):
        for dy in (-h, h):
            for dx in (-h, h):
                verts.append(o + Rp @ np.array([dx, dy, dz], np.float32))
    return np.asarray(verts, np.float32)


def draw_ar_cube(img, cam, R, t, plane: PlaneFit, size: float = 0.5):
    """Overlay a wireframe cube resting on the detected plane.

    img: (H, W) grayscale array or PIL Image; cam: PinholeCamera; (R, t):
    world->camera pose of the frame (numpy). Returns a PIL Image.
    """
    from PIL import Image, ImageDraw

    if not isinstance(img, Image.Image):
        arr = np.clip(np.asarray(img), 0, 255).astype(np.uint8)
        img = Image.fromarray(arr).convert("RGB")
    d = ImageDraw.Draw(img)
    Xc = se3_apply(torch.as_tensor(np.asarray(R), dtype=torch.float32),
                   torch.as_tensor(np.asarray(t), dtype=torch.float32),
                   torch.from_numpy(cube_vertices(plane, size)))
    uv = project(cam, Xc).numpy()
    Xc = Xc.numpy()
    vis = Xc[:, 2] > 0.05
    for a, b in _CUBE_EDGES:
        if vis[a] and vis[b]:
            d.line([float(uv[a, 0]), float(uv[a, 1]), float(uv[b, 0]), float(uv[b, 1])],
                   fill=(255, 60, 60), width=2)
    return img
